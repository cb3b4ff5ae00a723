"""The Sobol' window: the large route's closed-form first-order and total
indices with their standard errors, ``DistributedGP.sobol_indices(...,
error=True)``, pass after pass at fixed hyperparameters from the cell's file,
on data staged once in set-up (float32 staging, as the route trains; the GSA
itself computes in float64). Set-up warms up with one pass. A pass that
starts before the window closes is finished and counted.

``correct`` holds the window's last pass to the float64 reference
(perfbench/reference/sobol.py), which works out K^-1 y again from the inputs:

  - alpha_gap: the largest |alpha - reference| over the largest |reference|,
    alpha the K^-1 y the pass handed its calibrator;
  - S_gap: the largest |S - reference| over both kinds and every input;
  - T_gap: the largest |T^2 - reference^2| / reference^2 over both kinds and
    every input (the empty slice's T is 0 on both sides).

The hyperparameters are benchmarks/error_gsa.py's point, where the port's
own error check is made. At the north star's trained optimum (s2/noise
~1.5e3, condition past 1e7) W, of which T is the root, is some 1e-18 of the
terms it is the difference of, below float64's rounding: two float64
computations of T differ there by 20 % to 50 times (PERF.md, PR 15)."""

from __future__ import annotations

import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import sobol as ref_sobol


class State:
    pass


def setup(ctx) -> State:
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    state = State()
    state.ctx, state.device = ctx, ctx.device
    data = ctx.problem.make(ctx.config, ctx.seed, ctx.folder)
    state.X, state.Y = data['X'], data['Y']
    N, M = state.X.shape
    hyper = ctx.cell['hypers']
    state.ls = np.asarray(hyper['ls'], dtype=np.float64).reshape(M)
    state.s2, state.noise = float(hyper['s2']), float(hyper['noise'])
    dgp = DistributedGP(N, state.device, dense_kernels=True)
    x_dev, y_dev = dgp.stage(state.X, state.Y)
    kinds = tuple(ctx.traffic['kinds'])
    state.kinds = kinds
    # K^-1 y as the pass hands it to its calibrator, in the original row order
    cls = calibrators.ClosedSobolWithError
    original = cls.from_arrays.__func__
    own = cls.__dict__.get('from_arrays')
    state.restore = (lambda: delattr(cls, 'from_arrays')) if own is None else (
        lambda: setattr(cls, 'from_arrays', own))

    def from_arrays(klass, *args, **kwargs):
        state.alpha = kwargs['K_inv_Y']
        return original(klass, *args, **kwargs)
    cls.from_arrays = classmethod(from_arrays)
    state.call = lambda: dgp.sobol_indices(state.ls, state.s2, state.noise, x_dev, y_dev,
                                           state.X, kind=kinds, error=True)
    state.timings_of = lambda: dict(dgp.last_gsa_timings)
    state.engine = dgp.engine
    _pass(state)
    state.passes = []
    return state


def _pass(state: State) -> Dict[str, Any]:
    start = time.perf_counter()
    out = state.call()
    harness.synchronize(state.device)
    record = {'start': start, 'end': time.perf_counter(), 'out': out,
              'timings': state.timings_of(), 'alpha': state.alpha}
    state.last = record
    return record


def window(state: State, seconds: float) -> Dict[str, float]:
    harness.synchronize(state.device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while not state.passes or state.passes[-1]['end'] < deadline:
        state.passes.append(_pass(state))
    state.window_s = state.passes[-1]['end'] - t0
    return {'gsa_pass_s': state.window_s / len(state.passes)}


def trace(state: State, record: Dict[str, Any]):
    """The passes' timings, and one pass more under the profiler."""
    record['gsa_intervals_s'] = [p['timings'].get('intervals_s') for p in state.passes]
    profile: Dict[str, Any] = {}
    with harness.profiled(state.device, profile):
        _pass(state)
    state.last = state.passes[-1]
    record['profile'] = profile


def close(state: State):
    """Restore the program's calibrator and drop its state; keep the last
    window pass's alpha on the host."""
    state.restore()
    state.alpha = state.last['alpha'].detach().reshape(-1).to('cpu', torch.float64).numpy()
    for record in state.passes:
        record.pop('alpha')
    state.last.pop('alpha', None)
    del state.call, state.timings_of


def check(state: State, control: bool = False) -> Dict[str, Dict[str, float]]:
    """The compared numbers beside their limits. With ``control`` the
    reference in float32 takes the program's place."""
    limits = state.ctx.cell['limits']
    device = state.device

    def reference(dtype):
        X = torch.as_tensor(state.X, dtype=dtype, device=device)
        y = torch.as_tensor(state.Y[:, 0], dtype=dtype, device=device)
        ls = torch.as_tensor(state.ls, dtype=dtype, device=device)
        out = ref_sobol.indices(X, y, ls, state.s2, state.noise)
        out['alpha'] = out['alpha'].to('cpu', torch.float64).numpy()
        return out

    ref = reference(torch.float64)
    if control:
        try:
            got = reference(torch.float32)
        except FloatingPointError:
            return {name: {'value': float('inf'), 'limit': limits[name]}
                    for name in ('alpha_gap', 'S_gap', 'T_gap')}
        alpha = got['alpha']
        S = got['S']
        T = got['T']
    else:
        out = state.last['out']
        alpha = state.alpha
        S = {k: [out['S'][k][m] for m in range(len(state.ls))] for k in state.kinds}
        T = {k: [out['T'][k][m] for m in range(len(state.ls))] for k in state.kinds}
    M = len(state.ls)

    def relative(got: float, want: float) -> float:
        if want == 0.0:
            return 0.0 if got == 0.0 else float('inf')
        return abs(got * got - want * want) / (want * want)
    numbers = {
        'alpha_gap': float(np.max(np.abs(alpha - ref['alpha'])) / np.max(np.abs(ref['alpha']))),
        'S_gap': max(abs(S[k][m] - ref['S'][k][m]) for k in state.kinds for m in range(M)),
        'T_gap': max(relative(T[k][m], ref['T'][k][m]) for k in state.kinds for m in range(M))}
    numbers = {name: (value if np.isfinite(value) else float('inf'))
               for name, value in numbers.items()}
    return {name: {'value': value, 'limit': limits[name]} for name, value in numbers.items()}


def counts(state: State) -> Tuple[int, int]:
    """(attempted, failed): the window's passes, and those whose S or T
    holds a value that is not finite."""
    failed = sum(int(not all(np.isfinite(v) for part in ('S', 'T') for k in state.kinds
                             for v in p['out'][part][k].values())) for p in state.passes)
    return len(state.passes), failed
