"""The north-star run of the large-N variant route: an ARD-RBF GP of N=20000
rows and M=30 inputs trained to convergence on one card, then its first-order
and total Sobol' indices.

Counterpart of ``benchmarks/north_star.py``: the same problem (seed 0,
X ~ N(0, 1) of shape (N, M), Y = sin(x0) + x1^2 / 2 + 0.1 eps), the same calls
(``DistributedGP.stage``, ``calibrate`` from ls=2, s2=1, noise=0.05,
``sobol_indices`` of both kinds cold then warm, two timed value+grads) and the
same JSON fields, plus the engine, the unit-gram launches of the descent,
the peak device memory of each stage (staging, training, the GSA) and of
the whole run beside what was held before it, and the card's name and power
limit. It trains in float32,
so every gram goes through the unit-gram kernel.

    python -m romcomma_tpu_torch.north_star [N] [M] [maxiter] [dense_kernels]
    torchrun --nproc-per-node=S -m romcomma_tpu_torch.north_star [N] [M] [maxiter] [dense_kernels]

``maxiter`` defaults to 5000, the reference's cap, so the descent stops on
scipy's own rule. ``dense_kernels`` defaults to the production selection, as
in ``benchmarks/north_star.py``: 1 on one device (the large route's engines:
'upper' below ``DistributedGP.CYCLIC2_SINGLE_CHIP_MIN_N`` rows, 'cyclic2'
from there), 0 on a mesh of several ranks (the block-cyclic 'cyclic'
engine); pass 1 or 0 to choose. The command needs a CUDA device. Under
torchrun each rank takes one card, and rank 0 prints the record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from romcomma_tpu_torch.ops import gram_kernels
from romcomma_tpu_torch.parallel.distributed import DistributedGP


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _synchronize(on: torch.device):
    if on.type == 'cuda':
        torch.cuda.synchronize(on)


def problem(N: int, M: int) -> Tuple[np.ndarray, np.ndarray]:
    """benchmarks/north_star.py's data: the first-order indices concentrate
    on inputs 0 and 1, and every other input is noise."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, M))
    Y = np.sin(X[:, :1]) + 0.5 * X[:, 1:2] ** 2 + 0.1 * rng.standard_normal((N, 1))
    return X, Y


def run(N: int = 20000, M: int = 30, maxiter: int = 5000, on: str = 'cuda', mesh=None,
        dense_kernels: Optional[bool] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the JSON record, the trained state: dgp, X, Y, x_dev, y_dev, ls, s2,
    noise). ``on`` is 'cuda' (the card, required there) or 'cpu', where the
    record's device numbers read None. ``mesh``: a ``make_n_mesh()`` mesh to
    train over, else the device ``on``. ``dense_kernels``: None for the
    production selection (True on one device or a one-rank mesh, False on
    several ranks), else DistributedGP's argument."""
    on = torch.device(on)
    if on.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('the north star is measured on a CUDA device, and there is none')
    ranks = 1 if mesh is None else mesh.size()
    if dense_kernels is None:
        dense_kernels = ranks == 1
    peaks: Dict[str, Optional[float]] = {}

    def peak(stage: Optional[str] = None):
        """The peak device memory since the last call, in GiB, as ``stage``'s."""
        if on.type == 'cuda':
            if stage is not None:
                peaks[stage] = torch.cuda.max_memory_allocated(on) / 2 ** 30
            torch.cuda.reset_peak_memory_stats(on)

    peak()
    held = torch.cuda.memory_allocated(on) / 2 ** 30 if on.type == 'cuda' else None
    X, Y = problem(N, M)

    t0 = time.perf_counter()
    dgp = DistributedGP(N, mesh=on if mesh is None else mesh, dtype=np.float32,
                        dense_kernels=bool(dense_kernels))
    x_dev, y_dev = dgp.stage(X, Y)
    _synchronize(on)
    t_stage = time.perf_counter() - t0
    peak('stage')

    t0, launches = time.perf_counter(), gram_kernels.LAUNCHES
    (ls, s2, noise), lml, iterations = dgp.calibrate(X, Y, ls0=np.full(M, 2.0), s2_0=1.0,
                                                      noise0=0.05, maxiter=maxiter)
    _synchronize(on)
    t_train = time.perf_counter() - t0
    train_launches = gram_kernels.LAUNCHES - launches
    peak('train')

    def gsa():
        t0 = time.perf_counter()
        S = dgp.sobol_indices(ls, s2, noise, x_dev, y_dev, X, kind=('first_order', 'total'))
        _synchronize(on)
        return S, time.perf_counter() - t0

    S, t_gsa = gsa()
    _, t_gsa_warm = gsa()
    warm_phases = dict(dgp.last_gsa_timings)
    peak('gsa')

    def valgrad():
        p = [t.clone().requires_grad_(True) for t in (ls, s2, noise)]
        t0 = time.perf_counter()
        torch.autograd.grad(dgp.lml(*p, x_dev, y_dev), p)
        _synchronize(on)
        return time.perf_counter() - t0

    valgrad_s = min(valgrad() for _ in range(2))
    peak('valgrad')
    out = {'N': N, 'M': M, 'dense_kernels': bool(dense_kernels), 'valgrad_s': valgrad_s,
           'iters': int(iterations),
           'train_launches': train_launches,
           'gsa_phases_warm': warm_phases, 'lml': float(lml), 'stage_s': t_stage,
           'train_s': t_train, 'gsa_both_kinds_s': t_gsa, 'gsa_both_kinds_warm_s': t_gsa_warm,
           'end_to_end_s': t_stage + t_train + t_gsa,
           'S1_first3': [round(S['first_order'][m], 4) for m in range(min(3, M))],
           'ST_first3': [round(S['total'][m], 4) for m in range(min(3, M))],
           'engine': dgp.engine, 'ranks': ranks,
           'peak_gib': max(peaks.values()) if peaks else None,
           'peak_gib_by_stage': peaks or None, 'held_gib': held,
           'device': torch.cuda.get_device_name(on) if on.type == 'cuda' else 'cpu',
           'card': _card() if on.type == 'cuda' else None}
    state = {'dgp': dgp, 'X': X, 'Y': Y, 'x_dev': x_dev, 'y_dev': y_dev, 'ls': ls, 's2': s2,
             'noise': noise}
    return out, state


def main(N: int = 20000, M: int = 30, maxiter: int = 5000,
         dense_kernels: Optional[int] = None) -> Dict[str, Any]:
    """Run the north star on the card and print its record as one JSON line;
    under torchrun, over the ranks' mesh, rank 0 printing."""
    dense = None if dense_kernels is None else bool(dense_kernels)
    if 'WORLD_SIZE' not in os.environ:
        out, _ = run(N, M, maxiter, dense_kernels=dense)
        print(json.dumps(out), flush=True)
        return out
    import torch.distributed as dist
    from romcomma_tpu_torch.parallel import multihost
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    multihost.init()
    try:
        out, _ = run(N, M, maxiter, mesh=make_n_mesh(), dense_kernels=dense)
        if dist.get_rank() == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return out


if __name__ == '__main__':
    main(*[int(a) for a in sys.argv[1:]])
