"""What every driver shares: spans recorded from outside around the calls
into the program's layers, the unit-gram launches by shape, and the
profiler's reading of the device.

Spans are kept in memory and read when the run ends. Each wrapper replaces a
module attribute of the program for the run and restores it on ``close``."""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


#: Host spans looked at, back from a gap's middle, for the one that holds it.
GAP_SCAN = 20000
#: The first word of the host spans the benchmark records.
LABEL = 'perfbench:'


class WindowClosed(Exception):
    """Raised inside the optimizer's objective once the window has closed."""


class Rounds:
    """Rounds of the optimizer: each call of the objective that
    ``ops.lbfgs`` hands to scipy (``minimize``) or evaluates for every live
    descent (``minimize_lockstep``), from the call's start to the moment its
    gradient reached the host (``_Packing.flat_grad`` returned). Records
    each round's members, points, values and gradients, and raises
    WindowClosed at the first round that starts after ``deadline`` or once
    ``stop_after`` rounds are recorded."""

    def __init__(self, lbfgs):
        self.lbfgs = lbfgs
        self.deadline: Optional[float] = None
        #: a round count at which the next round raises WindowClosed too
        self.stop_after: Optional[int] = None
        self.rounds: List[Dict[str, Any]] = []
        self.closed_at: Optional[float] = None
        self.label: Optional[Callable[[str], Any]] = None
        self._pending: Optional[Dict[str, Any]] = None
        self._saved = {'minimize': lbfgs.minimize, 'minimize_lockstep': lbfgs.minimize_lockstep,
                       'flat_grad': lbfgs._Packing.flat_grad}
        saved = self._saved
        recorder = self

        def minimize(fun, params, *args, **kwargs):
            def single(p):
                recorder._start([0], {name: value.detach()[None] for name, value in p.items()})
                value = fun(p)
                recorder._pending['values'] = value.detach()[None]
                return value
            return saved['minimize'](single, params, *args, **kwargs)

        def minimize_lockstep(fun, starts, *args, **kwargs):
            def batched(members, p):
                recorder._start(list(members), {name: value.detach() for name, value in p.items()})
                values = fun(members, p)
                recorder._pending['values'] = values.detach()
                return values
            return saved['minimize_lockstep'](batched, starts, *args, **kwargs)

        def flat_grad(packing, grads, rows):
            out = saved['flat_grad'](packing, grads, rows)
            recorder._end(out)
            return out

        lbfgs.minimize, lbfgs.minimize_lockstep = minimize, minimize_lockstep
        lbfgs._Packing.flat_grad = flat_grad

    def close(self):
        self.lbfgs.minimize = self._saved['minimize']
        self.lbfgs.minimize_lockstep = self._saved['minimize_lockstep']
        self.lbfgs._Packing.flat_grad = self._saved['flat_grad']

    def _start(self, members: List[int], points: Dict[str, torch.Tensor]):
        now = time.perf_counter()
        if ((self.deadline is not None and now >= self.deadline)
                or (self.stop_after is not None and len(self.rounds) >= self.stop_after)):
            self.closed_at = now
            raise WindowClosed
        if self.label is not None:
            self.label(LABEL + ' value+grad of the live descents')
        self._pending = {'start': now, 'members': members, 'points': points}

    def _end(self, grads: np.ndarray):
        pending, self._pending = self._pending, None
        pending['end'] = time.perf_counter()
        if self.label is not None:
            self.label(LABEL + ' the scipy steps on the host')
        pending['values'] = pending['values'].to('cpu', torch.float64).numpy()
        pending['points'] = {name: value.to('cpu', torch.float64).numpy()
                             for name, value in pending['points'].items()}
        pending['grads'] = grads
        self.rounds.append(pending)


class Launches:
    """The unit-gram kernel's launches by shape, (n, A, B, M, u is v), from
    a wrapper of ``ops.gram_kernels.unit_gram_cuda``; counted only while
    ``on`` is set."""

    def __init__(self, gram_kernels):
        self.module = gram_kernels
        self.on = False
        self.shapes: List[tuple] = []
        original = self._original = gram_kernels.unit_gram_cuda

        def unit_gram_cuda(u, v):
            if self.on:
                n = u.shape[0] if u.dim() == 3 else 1
                self.shapes.append((n, u.shape[-2], v.shape[-2], u.shape[-1],
                                    u.data_ptr() == v.data_ptr() and u.shape == v.shape))
            return original(u, v)

        gram_kernels.unit_gram_cuda = unit_gram_cuda

    def close(self):
        self.module.unit_gram_cuda = self._original


def synchronize(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------- #
# The device, read from torch.profiler
# --------------------------------------------------------------------------- #

def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


@contextmanager
def profiled(device: torch.device, into: Dict[str, Any]):
    """Profile the body on ``device`` (CPU and CUDA activity) and fill
    ``into`` with the device's reading: ``window_s`` (host clock, the body
    ending in a synchronize), ``busy_s`` (the union of the intervals in
    which a kernel, copy or set ran), ``kernel_s`` by kernel name,
    ``device_ops`` (the ten longest by total time) and ``idle_gaps`` (the
    idle time between device activity, summed by the innermost host span
    open at each gap's middle, the ten largest)."""
    from torch.autograd import DeviceType
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        synchronize(device)
        t0 = time.perf_counter()
        yield
        synchronize(device)
        into['window_s'] = time.perf_counter() - t0
    events = list(prof.events())
    # the device's own work: a host span the profiler mirrors on the device's
    # timeline (a user annotation) is not
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False)
                 and not e.name.startswith(LABEL)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    intervals = _union([(e.time_range.start, e.time_range.end) for e in on_device])
    into['busy_s'] = sum(end - start for start, end in intervals) / 1e6
    kernel_s: Dict[str, float] = {}
    for e in on_device:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    into['kernel_s'] = kernel_s
    into['device_ops'] = [[name[:160], seconds] for name, seconds in
                          sorted(kernel_s.items(), key=lambda item: -item[1])[:10]]
    gaps: Dict[str, float] = {}
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
    starts = [s[0] for s in spans]
    for (_, end), (start, _) in zip(intervals, intervals[1:]):
        middle = 0.5 * (end + start)
        inner = None
        # the latest-starting span that holds the middle is the innermost
        for i in range(bisect.bisect_right(starts, middle) - 1,
                       max(-1, bisect.bisect_right(starts, middle) - 1 - GAP_SCAN), -1):
            if spans[i][1] >= middle:
                inner = spans[i][2]
                break
        name = (inner or 'host outside any recorded span')[:160]
        gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e6
    into['idle_gaps'] = [[name, seconds] for name, seconds in
                         sorted(gaps.items(), key=lambda item: -item[1])[:10]]


class Labels:
    """Host spans for the profiler, one open at a time: ``labels(name)``
    closes the open one and opens ``name``; ``close()`` closes it."""

    def __init__(self):
        self._open = None

    def __call__(self, name: str):
        self.close()
        self._open = torch.autograd.profiler.record_function(name)
        self._open.__enter__()

    def close(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
