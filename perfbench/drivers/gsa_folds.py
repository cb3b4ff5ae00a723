"""The fold-batched Sobol' window: csv_script's GSA (every kind, standard
errors, ``is_T_partial=False``) of K equal folds' variant anisotropic MOGPs,
``calibrators.marginalize_all_kinds_folds`` as ``user.run.gsa`` takes it,
pass after pass at fixed hyperparameters from the cell's file.

Set-up writes the configuration's CSV, splits it with the port's data layer
as ``into_K_folds(K)`` does under Python's random seeded with the run's
seed, builds each of the K folds' 'gpr.v.a' MOGPs with the cell's
``hypers`` (the same for every fold), and the Sobol' objects of the traffic's
kinds, whose slices and meta the pass takes, as ``user.run.gsa`` does. A
pass drops the models' cached posterior factors, so it factorizes each
fold's K in float64 as a fresh ``run.gsa`` does, then runs the one stacked
pass of every fold, kind and slice; it ends in a synchronize. Set-up warms
up with one pass; a pass that starts before the window closes is finished
and counted. The Sobol' tables are not written (host file I/O).

``correct`` holds the closed kind of the traffic's ``check_folds`` in the
window's last pass to the plain float64 reference
(perfbench/reference/sobol_closed.py), on the reference's own folds and
normalization of the CSV:

  - S_gap: the largest |S - reference| over every output pair and slice;
  - T_gap: the largest |T^2 - reference^2| over each output's own T and
    every slice, over the largest reference^2 of the fold (T is the root of
    a cancelling quadratic form, near 0 at the full slice)."""

from __future__ import annotations

import bisect
import random
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import folds as ref_folds
from perfbench.reference import lml as ref_lml
from perfbench.reference import sobol_closed as ref_closed


class State:
    pass


def setup(ctx) -> State:
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.gsa.models import GSA, Sobol
    from romcomma_tpu_torch.models.gpr import MOGP
    state = State()
    state.ctx, state.device = ctx, ctx.device
    t0 = time.perf_counter()
    data = ctx.problem.make(ctx.config, ctx.seed, ctx.folder)
    t1 = time.perf_counter()
    K = int(ctx.config['K'])
    repo = Repository.from_csv(ctx.folder / 'repo', data['csv'])
    random.seed(ctx.seed)                     # Python's random draws the fold labels
    repo.into_K_folds(K)
    hypers = ctx.cell['hypers']
    gps = []
    for k in range(K):
        gp = MOGP('gpr.v.a', Fold(repo, k), False, False, False)
        gp.kernel.data.replace(variance=np.asarray(hypers['variance'], dtype=np.float64)[None, :],
                               lengthscales=np.asarray(hypers['lengthscales'], dtype=np.float64))
        gp.likelihood.data.replace(variance=np.asarray(hypers['noise'], dtype=np.float64)[None, :])
        gps.append(gp)
    kinds = [GSA.Kind[name.upper()] for name in ctx.traffic['kinds']]
    sobols = [Sobol(gps[0], kind, -1, True, is_T_partial=bool(ctx.traffic['is_T_partial']))
              for kind in kinds]
    state.kind_slices = {s.kind.name: tuple(s._m_dataset) for s in sobols}
    state.meta = sobols[0].meta
    state.gps, state.csv, state.K = gps, data['csv'], K
    state.N, state.M, state.L = gps[0].N, gps[0].M, gps[0].L
    state.engine = f'marginalize_all_kinds_folds x{K}'
    t2 = time.perf_counter()
    _pass(state)
    state.passes: List[Dict[str, Any]] = []
    state.setup_parts = {'data_s': t1 - t0, 'program_s': t2 - t1,
                         'warm_pass_s': time.perf_counter() - t2}
    return state


def _pass(state: State) -> Dict[str, Any]:
    from romcomma_tpu_torch.gsa.calibrators import marginalize_all_kinds_folds
    start = time.perf_counter()
    for gp in state.gps:
        gp._posterior_cache = None            # a fresh run.gsa factorizes K again
    outs = marginalize_all_kinds_folds(state.gps, state.kind_slices, True, **state.meta)
    harness.synchronize(state.device)
    record = {'start': start, 'end': time.perf_counter(), 'outs': outs}
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


@contextmanager
def _profiled(device: torch.device, into: Dict[str, Any]):
    """``harness.profiled``'s reading (``window_s``, ``busy_s``, ``kernel_s``,
    ``device_ops``, ``idle_gaps``) from the profiler's raw events of the
    device's activity alone. A pass of this cell launches some 2·10^5
    kernels under 2·10^6 host events; building the profiler's event tree
    from them took 205 s on an H100 (PERF.md), the raw events a few.
    Idle gaps are named by the innermost CUDA runtime call open at their
    middle (no operator is recorded)."""
    from torch.autograd import DeviceType
    activities = [torch.profiler.ProfilerActivity.CPU] if device.type != 'cuda' else [
        torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        harness.synchronize(device)
        t0 = time.perf_counter()
        yield
        harness.synchronize(device)
        into['window_s'] = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    on_device, host = [], []
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            if not getattr(e, 'is_user_annotation', bool)() and not span[2].startswith(
                    harness.LABEL):
                on_device.append(span)
        else:
            host.append(span)
    intervals = harness._union([(start, end) for start, end, _ in on_device])
    into['busy_s'] = sum(end - start for start, end in intervals) / 1e9
    kernel_s: Dict[str, float] = {}
    for start, end, name in on_device:
        kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) / 1e9
    into['kernel_s'] = kernel_s
    into['device_ops'] = [[name[:160], seconds] for name, seconds in
                          sorted(kernel_s.items(), key=lambda item: -item[1])[:10]]
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(intervals, intervals[1:]):
        middle = 0.5 * (end + start)
        inner = None
        first = bisect.bisect_right(starts, middle) - 1
        for i in range(first, max(-1, first - harness.GAP_SCAN), -1):
            if host[i][1] >= middle:
                inner = host[i][2]
                break
        name = (inner or 'host outside any recorded call')[:160]
        gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e9
    into['idle_gaps'] = [[name, seconds] for name, seconds in
                         sorted(gaps.items(), key=lambda item: -item[1])[:10]]


def trace(state: State, record: Dict[str, Any]):
    """One pass more under the profiler. This path keeps no interval
    timings of its own: ``gsa_intervals_s`` is empty, so its reader reads
    nothing here, and the device readers read the profile."""
    record['gsa_intervals_s'] = []
    profile: Dict[str, Any] = {}
    last = state.passes[-1]
    with _profiled(state.device, profile):
        _pass(state)
    state.last = last
    record['profile'] = profile


def close(state: State):
    """Keep the last window pass's closed-kind tables of the checked folds on
    the host, the folds' program hyperparameters with them, and drop the
    models."""
    folds = [int(k) for k in state.ctx.traffic['check_folds']]
    outs = state.last['outs']
    state.closed = {k: {key: outs[k][0]['CLOSED'][key].detach().to('cpu', torch.float64)
                        for key in ('S', 'T')} for k in folds}
    state.raw = {k: {name: value.detach().to('cpu', torch.float64)
                     for name, value in state.gps[k]._variant_raw().items()} for k in folds}
    for record in state.passes:
        record.pop('outs', None)
    del state.gps, state.last


def check(state: State, control: bool = False) -> Dict[str, Dict[str, float]]:
    """The compared numbers beside their limits. With ``control`` the
    reference in float32 takes the program's place."""
    limits = state.ctx.cell['limits']
    device = state.device
    hypers = state.ctx.cell['hypers']
    slices = list(state.kind_slices['CLOSED'])
    table = ref_folds.read_csv(state.csv)
    labels = ref_folds.fold_labels(table.shape[0], state.K, state.ctx.seed)
    S_gap = T_gap = 0.0
    for k, got in state.closed.items():
        X, Y = ref_folds.normalized_fold(table, labels, k, state.M)

        def reference(dtype):
            # the program trains and factorizes at its float32 inputs and raw leaves
            x, y = (torch.as_tensor(a.to(torch.float32), dtype=dtype, device=device)
                    for a in (X, Y))
            raw = {name: value.to(device) for name, value in state.raw[k].items()}
            gram = (ref_lml.softplus(raw['raw_lengthscales']).to(dtype),
                    ref_lml.softplus(raw['raw_variance']).to(dtype))
            noise = (1e-6 + ref_lml.softplus(raw['raw_noise'])).to(dtype)
            ls = torch.as_tensor(hypers['lengthscales'], dtype=dtype, device=device)
            s2 = torch.as_tensor(hypers['variance'], dtype=dtype, device=device)
            out = ref_closed.indices(x, y, ls, s2, noise, slices, gram=gram)
            return {key: out[key].to('cpu', torch.float64) for key in ('S', 'T')}
        want = reference(torch.float64)
        if control:
            got = reference(torch.float32)
            T = got['T']
        else:
            T = torch.diagonal(got['T'], dim1=0, dim2=1).T
        S_gap = max(S_gap, float(torch.max(torch.abs(got['S'] - want['S']))))
        T_gap = max(T_gap, float(torch.max(torch.abs(T * T - want['T'] ** 2))
                                 / torch.max(want['T'] ** 2)))
    numbers = {'S_gap': S_gap, 'T_gap': T_gap}
    numbers = {name: (value if np.isfinite(value) else float('inf'))
               for name, value in numbers.items()}
    return {name: {'value': value, 'limit': limits[name]} for name, value in numbers.items()}


def counts(state: State) -> Tuple[int, int]:
    """(attempted, failed): the window's passes, and those whose tables hold
    a value that is not finite in any fold."""
    failed = sum(not all(bool(torch.all(torch.isfinite(v))) for by_kind, _ in record['outs']
                         for part in by_kind.values() for v in part.values())
                 for record in state.passes)
    return len(state.passes), failed
