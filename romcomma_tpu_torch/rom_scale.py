"""ROM at scale: the alternating rotation loop on one fold of N=8192 rows and
M=10 inputs whose target lives on a planted, non-axis-aligned plane, then the
principal angles between that plane and the learned basis.

Counterpart of ``benchmarks/rom_scale.py``: the same problem (seed 0, the
plane (v1, v2) from the QR of a standard normal (M, M), X uniform, y =
sin(2 z.v1) + (z.v2)^2 / 2 + 0.05 eps in the fold's normalized coordinates
z), the same ROM arguments (m=2, maxiter=5000, theta_maxiter=100,
theta_starts=3, sample_size=1024) and the same fields (``S_m_history``,
``principal_angles_deg``), plus each stage's seconds, the 'sobol'
objective's value+grad count and milliseconds, one LML value+grad and one
256-point predict_gradient at the final model, the unit-gram launches, peak
device memory, the rotation's orthonormality, and the card's name and power
limit.

    ROMCOMMA_X64=0 python -m romcomma_tpu_torch.rom_scale [N] [M] [iterations] [method]

``ROMCOMMA_X64=0`` (read when the package is imported) trains in float32, so
every gram of the calibrations goes through the unit-gram kernel; the
record's ``dtype`` says which ran. The command needs a CUDA device; the
repository is written under ``build/rom_scale`` of the checkout.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import pandas as pd
import torch
from scipy.stats import norm

from romcomma_tpu_torch.base.definitions import FLOAT, pinned_device
from romcomma_tpu_torch.data.storage import Fold, Repository
from romcomma_tpu_torch.gsa.calibrators import ClosedSobolWithRotation
from romcomma_tpu_torch.models.gp import lml_variant
from romcomma_tpu_torch.models.gpr import MOGP
from romcomma_tpu_torch.ops import gram_kernels
from romcomma_tpu_torch.rom import ROM

#: benchmarks/rom_scale.py's ROM arguments, those the command line does not set.
ROM_OPTIONS = {'m': 2, 'maxiter': 5000, 'theta_maxiter': 100, 'theta_starts': 3,
               'sample_size': 1024}
ROOT = Path(__file__).resolve().parents[1] / 'build' / 'rom_scale'


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _synchronize(on: torch.device):
    if on.type == 'cuda':
        torch.cuda.synchronize(on)


def problem(N: int, M: int) -> Tuple[pd.DataFrame, np.ndarray]:
    """(the repository's data frame, the planted plane (M, 2))."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    v1, v2 = Q[:, 0], Q[:, 1]
    X = rng.uniform(size=(N, M))
    z = norm.ppf(np.clip(X, 1e-12, 1 - 1e-12))     # the fold's normalization
    y = np.sin(2.0 * (z @ v1)) + 0.5 * (z @ v2) ** 2 + 0.05 * rng.standard_normal(N)
    columns = pd.MultiIndex.from_tuples([('X', f'X.{i}') for i in range(M)] + [('Y', 'Y.0')])
    return (pd.DataFrame(np.column_stack([X, y]), columns=columns, dtype=float),
            np.stack([v1, v2], axis=1))


def principal_angles_deg(plane: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Principal angles between span(plane's columns) and span(rows)."""
    qa, _ = np.linalg.qr(plane)
    qb, _ = np.linalg.qr(rows.T)
    return np.degrees(np.arccos(np.clip(np.linalg.svd(qa.T @ qb, compute_uv=False), -1, 1)))


def _min_ms(on: torch.device, fn, repeats: int = 3) -> float:
    """The least of ``repeats`` host-clock times of fn(), each ending in a
    synchronize, after one untimed call."""
    fn()
    times = []
    for _ in range(repeats):
        _synchronize(on)
        t0 = time.perf_counter()
        fn()
        _synchronize(on)
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def run(N: int = 8192, M: int = 10, iterations: int = 3, method: str = 'sobol',
        on: str = 'cuda', root: Optional[Path] = None, **rom_options
        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the JSON record, the state: rom, fold, plane). ``on`` is 'cuda' (the
    card, required there) or 'cpu', where the record's device numbers read
    None. ``rom_options`` override ROM_OPTIONS."""
    on = torch.device(on)
    if on.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('rom_scale is measured on a CUDA device, and there is none')
    root = ROOT if root is None else Path(root)
    with pinned_device(on):
        if on.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(on)
        t0 = time.perf_counter()
        df, plane = problem(N, M)
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        fold = Fold(Repository.from_df(root / 'repo', df).into_K_folds(-1), 0)
        stage_s = time.perf_counter() - t0

        launches, t0 = gram_kernels.LAUNCHES, time.perf_counter()
        rom = ROM('rom', fold, iterations=iterations, rotation_method=method,
                  **(ROM_OPTIONS | rom_options))
        meta = rom.calibrate()
        _synchronize(on)
        rom_s = time.perf_counter() - t0
        rom_launches = gram_kernels.LAUNCHES - launches
        peak = torch.cuda.max_memory_allocated(on) / 2 ** 30 if on.type == 'cuda' else None

        rotation = np.loadtxt(rom.folder / 'rotation.csv', delimiter=',')
        angles = principal_angles_deg(plane, rotation[:2])
        gp = MOGP(rom.gp_name, fold, True, False, False)
        raw, x, y = gp._variant_raw(), gp._tensor(gp.X), gp._tensor(gp.Y)

        def lml_value_and_grad():
            """One value+grad of the calibrations' objective at the optimum."""
            p = {name: t.detach().clone().requires_grad_(True) for name, t in raw.items()}
            torch.autograd.grad(lml_variant(p, x, y).sum(), list(p.values()))

        lml_ms = _min_ms(on, lml_value_and_grad)
        Z = np.random.default_rng(1).standard_normal((ROM.GRADIENT_BATCH, M))
        gradient_ms = _min_ms(on, lambda: gp.predict_gradient(Z))
        cal, Mu = ClosedSobolWithRotation(gp), int(rom.meta['m'])

        def s_rotated_value_and_grad():
            """optimize_theta's objective and its gradient, at the identity."""
            A = torch.zeros(M * (M - 1) // 2, dtype=torch.float64, device=on, requires_grad=True)
            value = -torch.mean(torch.diagonal(cal.S_rotated(cal._cayley(A, M)[:Mu])))
            torch.autograd.grad(value, A)

        s_rotated_ms = _min_ms(on, s_rotated_value_and_grad)
    evaluations = sum(t['evaluations'] for t in rom.theta_timings)
    theta_s = sum(t['seconds'] for t in rom.theta_timings)
    out = {'N': N, 'M': M, 'method': method, 'dtype': FLOAT().name,
           'iterations_run': len(meta['history']) - 1,
           'S_m_history': [h['S_m'] for h in meta['history']],
           'principal_angles_deg': [float(a) for a in angles],
           'rotation_orthonormality': float(np.abs(rotation @ rotation.T - np.eye(M)).max()),
           'rotation_det': float(np.linalg.det(rotation)),
           'stage_s': stage_s, 'rom_s': rom_s, 'stage_seconds': dict(rom.seconds),
           'S_rotated_evaluations': evaluations,
           'S_rotated_ms_in_descent': theta_s / evaluations * 1e3 if evaluations else None,
           'S_rotated_valgrad_ms': s_rotated_ms,
           'predict_gradient_256_ms': gradient_ms, 'lml_valgrad_ms': lml_ms,
           'unit_gram_launches': rom_launches, 'peak_gib': peak,
           'device': torch.cuda.get_device_name(on) if on.type == 'cuda' else 'cpu',
           'card': _card() if on.type == 'cuda' else None}
    return out, {'rom': rom, 'fold': fold, 'plane': plane, 'meta': meta}


def main(N: int = 8192, M: int = 10, iterations: int = 3, method: str = 'sobol'
         ) -> Dict[str, Any]:
    """Run the ROM at scale on the card and print its record as one JSON line."""
    out, _ = run(N, M, iterations, method)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    arguments = sys.argv[1:]
    main(*([int(a) for a in arguments[:3]] + arguments[3:4]))
