"""On the card, at each cell's own size: the control (the reference in the
precision below the one the configuration states, in the program's place)
comes out not correct, and the sound program correct, under the limits the
cell's file holds. Skips where there is no CUDA device."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
#: A short window each: the control needs the program's evaluation points
#: only, and the Sobol' pass none.
SECONDS = {'csv_k20.fit': 8, 'north_star.fit': 8, 'north_star.gsa': 3}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _control(workload: str, mode: str, seed: int):
    done = subprocess.run([sys.executable, str(ROOT / 'perfbench' / 'control.py'), '--workload',
                           workload, '--seeds', str(seed), '--seconds', str(SECONDS[workload]),
                           '--mode', mode], cwd=ROOT, env=dict(os.environ), capture_output=True,
                          text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize('workload', sorted(SECONDS))
def test_the_control_is_not_correct(card, workload):
    out = _control(workload, 'control', 2 ** 31 + 101)
    assert out['correct'] is False, out['checked']


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['north_star.gsa'])
def test_the_sound_program_is_correct(card, workload):
    out = _control(workload, 'program', 2 ** 31 + 103)
    assert out['correct'] is True, out['checked']
