#!/usr/bin/env python3
"""The cost and the coverage of the program's spans (``base.tracing``) in one
cell of ``BENCHMARK.json``, on one card:

    python3 tools/span_cost.py <cell> <seed> [window seconds] [pairs] [gap scan]

First the cost of one span on the card, in microseconds, recorded under a
profiler (CUDA events and the profiler's label) and off. Then the cell's
set-up and a short window, and its traced segment (the profiled rounds or
pass of ``perfbench/drivers/<driver>.py``'s ``trace``): once to warm the
profiler up, then ``pairs`` times with tracing 'auto' (the spans on, as the
benchmark's ``--trace 1`` runs them) and with tracing 'off', in turns (auto,
off, off, auto, ...). With a gap scan, one segment more in 'auto' names the
idle gaps with ``perfbench.harness.GAP_SCAN`` at that many host events.
One JSON line per segment: the mode, the segment's host seconds, the
device's busy seconds, every per-layer metric the cell reports (those read
from the window as the benchmark reads them), the spans by name (count,
mean host and device ms) and the ten largest idle gaps. It needs a CUDA
device; the window is too short for the cell's comparison, which it does
not make."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness, run  # noqa: E402


def per_span_us(on, n: int = 2000) -> dict:
    """Microseconds of one empty span on ``on``: under a profiler in 'auto'
    (recorded, with its events and label), and 'off'."""
    import torch
    from romcomma_tpu_torch.base import tracing
    out = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        for mode in ('off', 'auto', 'off', 'auto'):
            previous = tracing.mode(mode)
            t0 = time.perf_counter()
            for _ in range(n):
                with tracing.span('span_cost.empty', on=on):
                    pass
            out[mode] = 1e6 * (time.perf_counter() - t0) / n
            tracing.mode(previous)
    tracing.spans()
    tracing.reset()
    return out


def segment(driver, state, files, workload: str, mode: str) -> dict:
    from romcomma_tpu_torch.base import tracing
    previous = tracing.mode(mode)
    tracing.reset()
    record: dict = {}
    # each segment reads its own launches; the fit driver's segment ends by
    # closing the optimizer's window again: keep the window's close, which
    # its per-round spans end at
    launches = getattr(state, 'launches', None)
    if launches is not None:
        launches.shapes.clear()
    rounds = getattr(state, 'rounds', None)
    closed_at = getattr(rounds, 'closed_at', None)
    try:
        driver.trace(state, record)
    finally:
        tracing.mode(previous)
        if rounds is not None:
            rounds.closed_at = closed_at
    metrics = {m['name']: run.reader(m['name']).read(record)
               for m in run.metrics_of(files['bench'], workload, True)}
    stages: dict = {}
    for s in tracing.spans():
        stage = stages.setdefault(s['name'], {'count': 0, 'host_ms': 0.0, 'device_ms': 0.0})
        stage['count'] += 1
        stage['host_ms'] += s['host_ms']
        stage['device_ms'] += s['device_ms'] or 0.0
    for stage in stages.values():
        stage['host_ms'] /= stage['count']
        stage['device_ms'] /= stage['count']
    tracing.reset()
    profile = record['profile']
    return {'mode': mode, 'window_s': profile['window_s'], 'busy_s': profile['busy_s'],
            'metrics': metrics, 'spans': stages, 'idle_gaps': profile['idle_gaps']}


def measure(workload: str, seed: int, seconds: float, pairs: int, gap_scan: int = 0,
            device: str = 'cuda:0', files=None):
    """The span's cost, set-up, the window and the segments, printed."""
    import importlib
    import tempfile
    from types import SimpleNamespace
    import torch
    from romcomma_tpu_torch.base.definitions import pinned_device
    files = files or run.cell_files(workload)
    on = torch.device(device)
    driver = importlib.import_module(f'perfbench.drivers.{files["traffic"]["driver"]}')
    with tempfile.TemporaryDirectory(prefix='span-cost-') as folder, \
            pinned_device(on if on.type == 'cpu' else None):
        print(json.dumps({'per_span_us': per_span_us(on)}), flush=True)
        ctx = SimpleNamespace(config=files['config'], traffic=files['traffic'],
                              cell=files['cell'], seed=seed, device=on, folder=Path(folder),
                              problem=importlib.import_module(
                                  f'perfbench.problems.{files["config"]["problem"]}'))
        state = driver.setup(ctx)
        driver.window(state, seconds)
        print(f'span_cost: {workload} seed {seed}; card {run.card()}', file=sys.stderr,
              flush=True)
        modes = ['warm-up'] + [('auto', 'off')[(i + i // 2) % 2] for i in range(2 * pairs)]
        for mode in modes:
            print(json.dumps(segment(driver, state, files, workload,
                                     'auto' if mode == 'warm-up' else mode) | {'mode': mode}),
                  flush=True)
        if gap_scan:
            scan, harness.GAP_SCAN = harness.GAP_SCAN, gap_scan
            try:
                print(json.dumps(segment(driver, state, files, workload, 'auto')
                                 | {'mode': f'auto, gap scan {gap_scan}'}), flush=True)
            finally:
                harness.GAP_SCAN = scan
        driver.close(state)


def main(argv) -> int:
    run._environment()
    import torch
    if not torch.cuda.is_available():
        print('span_cost: no CUDA device', file=sys.stderr)
        return 2
    measure(argv[0], int(argv[1]), float(argv[2]) if len(argv) > 2 else 8.0,
            int(argv[3]) if len(argv) > 3 else 3, int(argv[4]) if len(argv) > 4 else 0)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
