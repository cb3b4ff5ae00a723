"""The training window: scipy's L-BFGS-B descents of the port's exact LML,
called again and again from the same starts while the window is open.

Two routes, as the traffic's ``route`` names them:

  - 'folds': csv_script's training. The CSV goes through the port's data
    layer (``Repository.from_csv``, ``into_K_folds``) under the run's
    temporary folder; each fold's MOGP is built as ``user.run`` builds it for
    a fold group, and the window calls ``models.gp.calibrate_variant_folds``
    over the K*L descents in lockstep, one batched ExactLML a round.
  - 'large': the large route, ``DistributedGP.calibrate`` on one card from
    the traffic's start, float32, its engine chosen by the program.

A unit is one call, from the starts to every descent's return; set-up warms
up with one round of it. The window ends at the first round that starts
after it closed; the call then in flight is abandoned.

``correct`` holds the timed rounds to the float64 reference
(perfbench/reference/lml.py), evaluated at the very points the program
evaluated, as a training step is held: the first round (every descent at its
start), the optimizer's first step from there, and the final round of each
completed call (every descent at its end). Five numbers, each beside its
limit from the cell's file:

  - start_lml_gap, end_lml_gap: the largest |objective - reference| / N at
    the starts, and at the ends;
  - start_grad_gap, end_grad_gap: the largest |gradient - reference|_inf
    there, over the reference's |gradient|_inf at that descent's start, in
    the optimizer's own (unconstrained) coordinates;
  - step_gap: the largest distance between the point each descent evaluates
    second and the one scipy's L-BFGS-B steps to from the reference's value
    and gradient at the start, over the length of that step: a descent that
    returns its start reads 1.

The rounds between are not compared: there the line search tries points at
which no float32 answer exists (lengthscales of 1e-12, the noise at its
floor with the gram's condition past 1e9), and the float32 objective departs
from float64's by as much as the point is wild (PERF.md, PR 15)."""

from __future__ import annotations

import math
import random
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from perfbench import flops, harness
from perfbench.reference import folds as ref_folds
from perfbench.reference import lml as ref_lml

#: Unconstrained leaf -> (hyperparameter, lower bound) of each route.
LEAVES = {'folds': {'raw_variance': ('s2', 0.0), 'raw_lengthscales': ('ls', 0.0),
                    'raw_noise': ('noise', 1e-6)},
          'large': {'ls': ('ls', 0.0), 's2': ('s2', 0.0), 'noise': ('noise', 1e-6)}}


class State:
    pass


def setup(ctx) -> State:
    """Build the route's inputs and calibration, then warm up with one round."""
    from romcomma_tpu_torch.ops import gram_kernels, lbfgs
    state = State()
    state.ctx, state.route = ctx, ctx.traffic['route']
    state.device = ctx.device
    t0 = time.perf_counter()
    data = ctx.problem.make(ctx.config, ctx.seed, ctx.folder)
    t1 = time.perf_counter()
    (_setup_folds if state.route == 'folds' else _setup_large)(state, data)
    t2 = time.perf_counter()
    state.rounds = harness.Rounds(lbfgs)
    state.launches = harness.Launches(gram_kernels)
    state.calls: List[Tuple[int, int]] = []
    _unit(state, first_rounds=1)
    state.rounds.rounds.clear()
    state.setup_parts = {'data_s': t1 - t0, 'program_s': t2 - t1,
                         'warm_round_s': time.perf_counter() - t2}
    return state


def _setup_folds(state: State, data: Dict[str, Any]):
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.models import gp as gp_module
    from romcomma_tpu_torch.models.gpr import MOGP
    from romcomma_tpu_torch.models.params import variant_mask
    config = state.ctx.config
    K = int(config['K'])
    repo = Repository.from_csv(state.ctx.folder / 'repo', data['csv'])
    random.seed(state.ctx.seed)                   # Python's random draws the fold labels
    repo.into_K_folds(K)
    gps = [MOGP('gpr.v.a', Fold(repo, k), False, False, False) for k in range(K)]
    meta, kernel_options, likelihood_options = gps[0]._calibration_options()
    mask = variant_mask(kernel_variance=kernel_options['variance'],
                        lengthscales=kernel_options['lengthscales']['variant'],
                        noise=likelihood_options['variance'])
    raws = [gp._variant_raw() for gp in gps]
    raws = {leaf: torch.stack([raw[leaf] for raw in raws]) for leaf in raws[0]}
    # each fold's X keeps the column-major layout MOGP trains on, as user.run does
    xs = torch.stack([gp._tensor(gp.X).mT for gp in gps]).mT
    ys = torch.stack([gp._tensor(gp.Y) for gp in gps])
    maxiter, gtol = int(meta.get('maxiter', 5000)), float(meta.get('gtol', 1e-16))
    state.call = lambda: gp_module.calibrate_variant_folds(raws, mask, xs, ys, maxiter=maxiter,
                                                           gtol=gtol)
    state.mask = {leaf: float(mask[leaf]) for leaf in raws}
    state.N, state.M, state.L, state.K = gps[0].N, gps[0].M, gps[0].L, K
    state.csv = data['csv']
    state.inputs = (xs, ys)


def _setup_large(state: State, data: Dict[str, Any]):
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    traffic = state.ctx.traffic
    X, Y = data['X'], data['Y']
    N, M = X.shape
    dgp = DistributedGP(N, state.device, dtype=np.float32, dense_kernels=True)
    dgp.stage(X, Y)
    start = traffic['start']
    ls0 = np.full(M, float(start['ls']))
    state.call = lambda: dgp.calibrate(X, Y, ls0=ls0, s2_0=float(start['s2']),
                                       noise0=float(start['noise']),
                                       maxiter=int(traffic.get('maxiter', 5000)))
    state.mask = {'ls': 1.0, 's2': 1.0, 'noise': 1.0}
    state.N, state.M, state.L, state.K = N, M, 1, 1
    state.X, state.Y = X, Y
    state.inputs = ()
    state.engine = dgp.engine


def _unit(state: State, first_rounds: int = 0):
    """One call from the starts; with ``first_rounds``, only its first
    rounds."""
    rounds = state.rounds
    if first_rounds:
        rounds.stop_after = len(rounds.rounds) + first_rounds
        try:
            state.call()
        except harness.WindowClosed:
            pass
        finally:
            rounds.stop_after = None
        return
    first = len(rounds.rounds)
    state.call()
    state.calls.append((first, len(rounds.rounds) - 1))


def window(state: State, seconds: float) -> Dict[str, Any]:
    """Calls from the starts until the window closes; the rounds' spans."""
    harness.synchronize(state.device)
    rounds = state.rounds
    t0 = rounds.t0 = time.perf_counter()
    rounds.deadline = t0 + seconds
    try:
        while True:
            _unit(state)
    except harness.WindowClosed:
        pass
    rounds.deadline = None
    state.window_s = rounds.closed_at - t0
    state.window_rounds = list(rounds.rounds)
    return end_to_end(state)


def end_to_end(state: State) -> Dict[str, float]:
    """eval_ms, the window over its descent evaluations (a round evaluates
    every live descent once), and round_p90_ms, the 90th percentile of the
    rounds' lengths (start to next start); '_calls_rounds_s' (rounds and
    seconds of each completed call) and '_evaluations' are notes for
    standard error."""
    rounds = state.window_rounds
    starts = [r['start'] for r in rounds] + [state.rounds.closed_at]
    durations = np.diff(np.asarray(starts))
    evaluations = sum(len(r['members']) for r in rounds)
    calls = [(last - first + 1, rounds[last]['end'] - rounds[first]['start'])
             for first, last in state.calls]
    return {'eval_ms': 1e3 * state.window_s / evaluations,
            'round_p90_ms': float(1e3 * np.percentile(durations, 90)),
            '_calls_rounds_s': calls, '_evaluations': evaluations, '_rounds': len(rounds)}


def trace(state: State, record: Dict[str, Any]):
    """The spans' record for the per-layer readers, and a profiled segment
    after the window: the first ``profile_rounds`` rounds of one call."""
    rounds = state.window_rounds
    ends = [r['end'] for r in rounds]
    nexts = [r['start'] for r in rounds[1:]] + [state.rounds.closed_at]
    record['route'] = state.route
    record['valgrad_s'] = [r['end'] - r['start'] for r in rounds]
    record['host_s'] = [n - e for n, e in zip(nexts, ends)]
    record['window_s'] = state.window_s
    record['model_flops'] = sum(len(r['members']) for r in rounds) * flops.lml_valgrad_flops(
        state.N, state.M)
    profile: Dict[str, Any] = {}
    labels = harness.Labels()
    state.rounds.label = labels
    state.launches.on = True
    try:
        with harness.profiled(state.device, profile):
            _unit(state, first_rounds=int(state.ctx.traffic['profile_rounds']))
            labels.close()
    finally:
        state.rounds.label = None
        state.launches.on = False
    del state.rounds.rounds[len(rounds):]
    profile['launches'] = list(state.launches.shapes)
    record['profile'] = profile


def close(state: State):
    """Restore the program's functions and drop its state."""
    state.rounds.close()
    state.launches.close()
    del state.call, state.inputs


# --------------------------------------------------------------------------- #
# correct
# --------------------------------------------------------------------------- #

def _members_inputs(state: State, device: torch.device):
    """Per descent: (x (N, M), y (N,)) float64 on ``device``, as the program
    trains on them: the reference's own folds and normalization, rounded to
    float32 as the float32 program's inputs are."""
    if state.route == 'large':
        x = torch.as_tensor(state.X.astype(np.float32), dtype=torch.float64, device=device)
        y = torch.as_tensor(state.Y[:, 0].astype(np.float32), dtype=torch.float64, device=device)
        return lambda i: (x, y)
    table = ref_folds.read_csv(state.csv)
    labels = ref_folds.fold_labels(table.shape[0], state.K, state.ctx.seed)
    cache: Dict[int, tuple] = {}

    def inputs(i: int):
        k, l = divmod(i, state.L)
        if k not in cache:
            cache.clear()
            X, Y = ref_folds.normalized_fold(table, labels, k, state.M)
            cache[k] = tuple(torch.as_tensor(a.to(torch.float32), dtype=torch.float64,
                                             device=device) for a in (X, Y))
        X, Y = cache[k]
        return X, Y[:, l]
    return inputs


def _reference(state: State, inputs, item: Dict[str, Any], dtype: torch.dtype,
               form: str = 'direct'):
    """(objective, gradient in the unconstrained leaves, flat in the
    program's order) of the reference at one recorded point."""
    leaves = LEAVES[state.route]
    x, y = inputs(item['member'])
    device = x.device
    x, y = x.to(dtype), y.to(dtype)
    raw = {name: torch.as_tensor(value, dtype=torch.float64, device=device)
           for name, value in item['point'].items()}
    hyper = {leaves[name][0]: leaves[name][1] + ref_lml.softplus(value)
             for name, value in raw.items()}
    ls = torch.broadcast_to(hyper['ls'], (state.M,))
    out = ref_lml.value_and_grad(x, y, ls.to(dtype), hyper['s2'].to(dtype),
                                 hyper['noise'].to(dtype), form)
    grads = []
    for name, value in raw.items():
        g = out[leaves[name][0]].to(torch.float64)
        g = g.sum_to_size(value.shape) if value.dim() else g
        grads.append((-g * torch.sigmoid(value) * state.mask[name]).reshape(-1))
    return -float(out['lml']), torch.cat(grads).cpu().numpy()


def _finals(state: State) -> List[int]:
    """The final round of each completed call, less those that repeat an
    earlier one bit for bit (a call from the same starts that reads the
    same numbers)."""
    rounds, finals, seen = state.window_rounds, [], set()
    for _, last in state.calls:
        key = b''.join(a.tobytes() for a in (*rounds[last]['points'].values(),
                                              rounds[last]['values'], rounds[last]['grads']))
        if key not in seen:
            seen.add(key)
            finals.append(last)
    return finals


def _item(state: State, j: int, r: int) -> Dict[str, Any]:
    rnd = state.window_rounds[j]
    return {'member': rnd['members'][r], 'value': float(rnd['values'][r]),
            'grad': np.asarray(rnd['grads'][r]),
            'point': {name: value[r] for name, value in rnd['points'].items()}}


def _flat(point: Dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([np.asarray(value, dtype=np.float64).reshape(-1)
                           for value in point.values()])


class _Trial(Exception):
    pass


def _first_step(x0: np.ndarray, value: float, grad: np.ndarray) -> np.ndarray:
    """The point scipy's L-BFGS-B evaluates after x0 where the objective
    there is (value, grad): a function of these alone, before any line
    search decides anything."""
    from scipy.optimize import minimize
    seen: List[np.ndarray] = []

    def objective(x):
        seen.append(np.array(x))
        if len(seen) > 1:
            raise _Trial
        return value, grad

    try:
        minimize(objective, x0, jac=True, method='L-BFGS-B',
                 options={'maxcor': 30, 'ftol': 2.220446049250313e-09, 'gtol': 1e-16})
    except _Trial:
        return seen[1]
    return x0                                 # scipy stopped at x0


def _second_points(state: State) -> Dict[int, np.ndarray]:
    """Each descent's second evaluation point in the window's first call
    (its final one, at its start, where it evaluated once only)."""
    count: Dict[int, int] = {}
    out: Dict[int, np.ndarray] = {}
    last = state.calls[0][1] if state.calls else len(state.window_rounds) - 1
    for rnd in state.window_rounds[:last + 1]:
        for r, member in enumerate(rnd['members']):
            count[member] = count.get(member, 0) + 1
            if count[member] == 2:
                out[member] = _flat({name: value[r] for name, value in rnd['points'].items()})
    return out


def check(state: State, control: bool = False) -> Dict[str, Dict[str, float]]:
    """The compared numbers beside their limits. With ``control`` the
    reference in float32, its gram's cross term a TF32 matmul, takes the
    program's place at the program's points."""
    device = state.device
    limits = state.ctx.cell['limits']
    inputs = _members_inputs(state, device)
    finals = _finals(state)
    items = [(j, r) for j in [0] + finals for r in range(len(state.window_rounds[j]['members']))]
    items.sort(key=lambda jr: state.window_rounds[jr[0]]['members'][jr[1]])
    reference: Dict[tuple, tuple] = {}
    candidate: Dict[tuple, tuple] = {}
    for j, r in items:
        item = _item(state, j, r)
        reference[j, r] = _reference(state, inputs, item, torch.float64)
        if control:
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                candidate[j, r] = _reference(state, inputs, item, torch.float32, 'expansion')
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        else:
            candidate[j, r] = (item['value'], item['grad'])
    first = state.window_rounds[0]
    start_scale = {member: float(np.max(np.abs(reference[0, r][1])))
                   for r, member in enumerate(first['members'])}

    def gaps(rounds_) -> Tuple[float, float]:
        lml = grad = 0.0
        for (j, r), (value, g) in candidate.items():
            if j not in rounds_:
                continue
            if not (np.isfinite(value) and np.all(np.isfinite(g))):
                return math.inf, math.inf
            ref_value, ref_grad = reference[j, r]
            member = state.window_rounds[j]['members'][r]
            lml = max(lml, abs(value - ref_value) / state.N)
            grad = max(grad, float(np.max(np.abs(g - ref_grad))) / start_scale[member])
        return lml, grad

    numbers = dict(zip(('start_lml_gap', 'start_grad_gap'), gaps({0})))
    # each descent's first step, against the one scipy takes from the
    # reference's value and gradient at the start
    seconds = _second_points(state)
    step = 0.0
    for r, member in enumerate(first['members']):
        x0 = _flat(_item(state, 0, r)['point'])
        x1_ref = _first_step(x0, *reference[0, r])
        if control:
            finite = np.isfinite(candidate[0, r][0]) and np.all(np.isfinite(candidate[0, r][1]))
            x1 = _first_step(x0, *candidate[0, r]) if finite else x0
        else:
            x1 = seconds.get(member, x0)
        moved = float(np.linalg.norm(x1_ref - x0))
        step = max(step, float(np.linalg.norm(x1 - x1_ref)) / moved if moved > 0 else 0.0)
    numbers['step_gap'] = step
    end = gaps(set(finals)) if finals else (math.inf, math.inf)
    numbers.update(zip(('end_lml_gap', 'end_grad_gap'), end))
    return {name: {'value': value, 'limit': limits[name]} for name, value in numbers.items()}


def counts(state: State) -> Tuple[int, int]:
    """(attempted, failed): the window's rounds, and its completed descents
    whose final objective is not finite."""
    failed = 0
    for _, last in state.calls:
        if last < len(state.window_rounds):
            failed += int(np.sum(~np.isfinite(state.window_rounds[last]['values'])))
    return len(state.window_rounds), failed
