"""Run one cell of BENCHMARK.json once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (perfbench/configs/<config>.json: the
deployment, whose ``problem`` names the data generator
perfbench/problems/<problem>.py) and a traffic mix
(perfbench/traffic/<traffic>.json, whose ``driver`` names the window
perfbench/drivers/<driver>.py); perfbench/cells/<cell>.json holds what
belongs to the pair, such as the limits of the comparison that decides
``correct``. With --trace 0 the line carries the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, each read by
perfbench/metrics/<metric>.py from the spans, counters and profiler trace.

The run needs CUDA devices as many as the cell's ``chips``; it exits with
code 2 and prints no result where there are fewer, and with code 3 where the
process holds jax, jaxlib, flax or romcomma_tpu once the window has closed.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Modules whose presence, compared by the top-level name, makes a run void.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'romcomma_tpu')


def _environment():
    """What the program reads at import: float32 training, no JAX behind
    transformers, and every build cache at a fixed path inside the checkout."""
    os.environ['ROMCOMMA_X64'] = '0'
    os.environ['USE_FLAX'] = '0'
    os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(ROOT / 'build' / 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton'))


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name for name in list(sys.modules)
                   if name.split('.', 1)[0] in FORBIDDEN})


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as handle:
        return json.load(handle)


def cell_files(workload: str, root: Path = ROOT) -> Dict[str, Any]:
    """The cell's entry of BENCHMARK.json and the files it names."""
    bench = load_json(root / 'BENCHMARK.json')
    entry = next((w for w in bench['workloads'] if w['name'] == workload), None)
    if entry is None:
        raise SystemExit(f'BENCHMARK.json has no workload {workload!r}')
    return {'bench': bench, 'entry': entry,
            'config': load_json(HERE / 'configs' / f'{entry["config"]}.json'),
            'traffic': load_json(HERE / 'traffic' / f'{entry["traffic"]}.json'),
            'cell': load_json(HERE / 'cells' / f'{workload}.json')}


def metrics_of(bench: Dict[str, Any], workload: str, trace: bool):
    """The metrics the cell reports: its end-to-end ones, or its per-layer
    ones, each with no ``workloads`` key or one that lists the cell."""
    if not trace:
        return [m for m in bench['end_to_end'] if workload in m.get('workloads', [workload])]
    ends = {m['name'] for m in metrics_of(bench, workload, False)}
    return [m for m in bench['per_layer']
            if workload in m.get('workloads', [workload] if m['moves'] in ends else [])]


def reader(name: str):
    """perfbench/metrics/<name>.py as a module."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'perfbench_metric_{name.replace(".", "_")}',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        done = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=30)
        return done.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi gave nothing'


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = 'cuda:0',
             files: Optional[Dict[str, Any]] = None, control: bool = False) -> Dict[str, Any]:
    """One run of the cell, past the look for a chip: set-up (with its warm
    unit), the window, the traced segment where ``trace``, then the
    comparison with the reference. Returns the result line as a dict."""
    _environment()
    import torch
    from romcomma_tpu_torch.base.definitions import pinned_device
    files = files or cell_files(workload)
    on = torch.device(device)
    ctx = SimpleNamespace(config=files['config'], traffic=files['traffic'], cell=files['cell'],
                          seed=int(seed), device=on,
                          problem=importlib.import_module(
                              f'perfbench.problems.{files["config"]["problem"]}'))
    driver = importlib.import_module(f'perfbench.drivers.{files["traffic"]["driver"]}')
    record: Dict[str, Any] = {}
    with tempfile.TemporaryDirectory(prefix='perfbench-') as folder, \
            pinned_device(on if on.type == 'cpu' else None):
        ctx.folder = Path(folder)
        if on.type == 'cuda':
            torch.cuda.set_device(on)
        state = driver.setup(ctx)
        setup_s = time.perf_counter() - PROCESS_START
        measured = driver.window(state, seconds)
        values = {'setup_s': setup_s, **measured}
        found = forbidden_modules()
        if found:
            print(f'the process holds {found} once the window has closed', file=sys.stderr)
            raise SystemExit(3)
        if trace:
            driver.trace(state, record)
        memory_peak = torch.cuda.max_memory_allocated(on) if on.type == 'cuda' else 0
        attempted, failed = driver.counts(state)
        driver.close(state)
        gc.collect()
        if on.type == 'cuda':
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checked = driver.check(state, control=control)
        values['_check_s'] = time.perf_counter() - t_check
    correct = all(c['value'] <= c['limit'] for c in checked.values())
    metrics = {}
    for metric in metrics_of(files['bench'], workload, trace):
        value = (values.get(metric['name']) if not trace else
                 reader(metric['name']).read(record))
        if value is not None:
            metrics[metric['name']] = {'value': value, 'unit': metric['unit']}
    info = {'platform': 'gpu' if on.type == 'cuda' else 'cpu',
            'kind': torch.cuda.get_device_name(on) if on.type == 'cuda' else 'cpu',
            'count': 1, 'memory_peak_bytes': int(memory_peak)}
    result: Dict[str, Any] = {'correct': correct, 'attempted': attempted, 'failed': failed,
                              'metrics': metrics, 'device': info}
    if trace and 'profile' in record:
        profile = record['profile']
        info['busy_s'] = profile['busy_s']
        info['window_s'] = profile['window_s']
        result['breakdown'] = {'device_ops': profile['device_ops'],
                               'idle_gaps': profile['idle_gaps']}
    result['checked'] = checked
    notes = {key: value for key, value in values.items() if key.startswith('_')}
    print(f'perfbench: {workload} seed {seed}; engine {getattr(state, "engine", "-")}; '
          f'calls or passes completed {len(getattr(state, "calls", getattr(state, "passes", [])))}; '
          f'{notes}; set-up {getattr(state, "setup_parts", {})}', file=sys.stderr)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    files = cell_files(args.workload)
    import torch
    chips = int(files['entry']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'this cell needs {chips} CUDA device(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), files=files)
    print(f'perfbench: card {card()}', file=sys.stderr)
    for name, c in result['checked'].items():
        print(f'perfbench: checked {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
