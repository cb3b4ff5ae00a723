"""Whole runs of every cell at tiny sizes on the CPU, each in a fresh
process, past the harness's look for a chip: the result line is whole and
``correct``, no module whose top-level name is jax, jaxlib, flax or
romcomma_tpu is loaded; and with each fault of perfbench/faults.py that a
cell can have planted underneath, ``correct`` comes out false. The card's
own runs are perfbench/run.py's; the control's are perfbench/control.py's
(see perfbench/README.md)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

#: The cells cut to sizes a CPU runs in seconds: the same files, smaller
#: numbers.
TINY = {
    'csv_k20.fit': {'config': {'N': 240, 'M': 8, 'K': 4}, 'traffic': {'check_evaluations': 20},
                    'seconds': 12},
    'north_star.fit': {'config': {'N': 300, 'M': 5}, 'seconds': 6},
    'north_star.gsa': {'config': {'N': 300, 'M': 5}, 'seconds': 2},
}
FAULTS = {'csv_k20.fit': ('unchanged', 'half', 'alter'),
          'north_star.fit': ('unchanged', 'half', 'alter'),
          'north_star.gsa': ('half', 'alter')}

SCRIPT = '''
import json, sys
import torch
torch.set_num_threads(2)
from perfbench import faults, run
workload, fault, trace, tiny = sys.argv[1], sys.argv[2], sys.argv[3] == '1', json.loads(sys.argv[4])
files = run.cell_files(workload)
for key in ('config', 'traffic', 'cell'):
    files[key] = dict(files[key], **tiny.get(key, {}))
if 'ls' in files['cell'].get('hypers', {}):
    hypers = files['cell']['hypers']
    files['cell']['hypers'] = dict(hypers, ls=hypers['ls'][:files['config']['M']])
if fault != 'none':
    faults.FAULTS[fault]()
result = run.run_cell(workload, 2 ** 31 + 11, tiny['seconds'], trace, device='cpu', files=files)
print(json.dumps({'result': result, 'forbidden': run.forbidden_modules()}))
'''


def _run(workload: str, fault: str = 'none', trace: bool = False):
    env = dict(os.environ, ROMCOMMA_X64='0', PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    done = subprocess.run([sys.executable, '-c', SCRIPT, workload, fault, '1' if trace else '0',
                           json.dumps(TINY[workload])], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('workload', sorted(TINY))
def test_a_sound_run_is_whole_correct_and_free_of_jax(workload):
    out = _run(workload, trace=workload == 'north_star.gsa')
    result = out['result']
    assert out['forbidden'] == []
    assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(result)[-1] == 'checked'
    assert result['correct'] is True, result['checked']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['device']) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    if workload != 'north_star.gsa':
        wanted = {m['name'] for m in bench['end_to_end']
                  if workload in m.get('workloads', [workload])}
        assert set(result['metrics']) == wanted
    else:
        assert 'gsa_intervals_s' in result['metrics']
        assert 'breakdown' in result


@pytest.mark.parametrize('workload,fault', [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_planted_fault_is_not_correct(workload, fault):
    result = _run(workload, fault)['result']
    assert result['correct'] is False, result['checked']
