"""Sobol' indices with standard errors (W/T) at scale on the large route,
checked against the CPU's float64 result from the same posterior.

Counterpart of ``benchmarks/error_gsa.py``: the same problem (the north
star's: seed 0, X ~ N(0, 1) of shape (N, M), Y = sin(x0) + x1^2 / 2 +
0.1 eps), the same point (ls 2, s2 1, noise 0.05), first-order and total
indices with errors through ``DistributedGP.sobol_indices(error=True)``,
and the same fields (``acc_error_gsa_s`` and its phases, ``cpu_oracle_s``,
``max_abs_dS_vs_cpu_f64``, ``max_abs_dT_vs_cpu_f64``, the leading S1 and
T1), plus T's distance as T^2 (T is the square root of a quadform that
cancels to ~0 on some entries), the peak device memory of the GSA and the
card's name and power limit. ``DistributedGP`` is built as the large route
builds it (``dense_kernels=True``: 'cyclic2' from
``CYCLIC2_SINGLE_CHIP_MIN_N`` rows, so the float64 factor is one
(Npad, Npad) buffer factorized in place), where the reference takes its
default engine. The oracle is the CPU's own float64 pass, with its own
float64 Cholesky factor, from the card's K^-1 y. The CPU's pass costs
O(N^2 M) on a few cores (about 14 s at N=2048 on eight), so above
ORACLE_MAX_N rows it is made on the problem's first ORACLE_MAX_N rows,
which the card then computes a second time through the same engine
(``oracle_N`` in the record says which).

    python -m romcomma_tpu_torch.error_gsa [N] [M] [n_chunk] [oracle] [mixed] [fast_v] [warm]

``n_chunk`` 0 takes the calibrator's automatic chunk; ``oracle`` 0 skips the
check; ``warm`` 1 runs the card's pass a second time. romcomma_tpu's
TPU tiers (``mixed`` '' | 'f64' | 'ff' | 'f32'; ``fast_v`` 1, its float32
V planes) are refused by name by ``sobol_indices``: only '' / 'f64' and 0
run. The command needs a CUDA device and prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from romcomma_tpu_torch.base.definitions import pinned_device
from romcomma_tpu_torch.north_star import _card, _synchronize, problem
from romcomma_tpu_torch.ops.linalg import cholesky
from romcomma_tpu_torch.parallel.distributed import (FAMILIES, DistributedGP, _from_stored_t,
                                                     ring_tile)

KINDS = ('first_order', 'total')
#: Rows up to which the CPU's float64 pass checks the card's at the run's own N.
ORACLE_MAX_N = 4096
#: romcomma_tpu's ``mixed`` argument: '' (the backend's default), 'f64', 'ff', 'f32'.
MIXED = {'': None, 'f64': False, 'ff': 'ff', 'f32': True}


def cpu_oracle(X: np.ndarray, alpha: np.ndarray, ls: np.ndarray, s2: float, noise: float,
               n_chunk: Optional[int]) -> Dict[str, np.ndarray]:
    """The float64 V and T columns of the CPU's pass ([0, M) then each
    kind's slices), from K^-1 y ``alpha`` (N,) and the CPU's own factor."""
    from romcomma_tpu_torch.gsa.calibrators import ClosedSobolWithError
    cpu = torch.device('cpu')
    N, M = X.shape
    with pinned_device(cpu):
        x64 = torch.as_tensor(X, dtype=torch.float64)
        K = ring_tile(x64, x64, torch.as_tensor(ls), torch.as_tensor(s2, dtype=torch.float64))
        K.diagonal().add_(noise)
        K_cho = cholesky(K)
        del K
        cal = ClosedSobolWithError.from_arrays(
            F=np.asarray([[s2]]), K_cho=K_cho[None], K_inv_Y=alpha.reshape(1, 1, N),
            Lambda=ls[None, :], X=X, is_F_diagonal=True, L=1, M=M, N=N, is_T_partial=True,
            **({} if n_chunk is None else {'n_chunk': n_chunk}))
        flat = [(0, M)] + [s for k in KINDS for s in FAMILIES[k](M)]
        out = cal.marginalize_intervals(tuple(flat))
        return {key: out[key][0, 0].numpy() for key in ('V', 'T')}


def run(N: int = 8192, M: int = 30, n_chunk: int = 0, oracle: int = 1,
        intervals_mixed=None, fast_v: int = 0, warm: int = 0, on: str = 'cuda'
        ) -> Dict[str, Any]:
    """The record. ``on`` is 'cuda' (required there) or 'cpu', where the
    device numbers read None."""
    on = torch.device(on)
    cuda = on.type == 'cuda'
    if cuda and not torch.cuda.is_available():
        raise RuntimeError('the error GSA is measured on a CUDA device, and there is none')
    X, Y = problem(N, M)
    ls, s2, noise = np.full(M, 2.0), 1.0, 0.05
    n_chunk = n_chunk or None
    t0 = time.perf_counter()
    dgp = DistributedGP(N, on, dense_kernels=True)
    x_dev, y_dev = dgp.stage(X, Y)
    _synchronize(on)
    t_stage = time.perf_counter() - t0
    options = dict(kind=KINDS, n_chunk=n_chunk, error=True, intervals_mixed=intervals_mixed,
                   **({'gsa_dtype': np.float32} if fast_v else {}))

    def card_pass():
        if cuda:
            held = torch.cuda.memory_allocated(on)
            torch.cuda.reset_peak_memory_stats(on)
        t0 = time.perf_counter()
        result = dgp.sobol_indices(ls, s2, noise, x_dev, y_dev, X, **options)
        _synchronize(on)
        return (result, time.perf_counter() - t0, dict(dgp.last_gsa_timings),
                (torch.cuda.max_memory_allocated(on) - held) / 2 ** 30 if cuda else None)

    acc, t_acc, acc_phases, acc_peak = card_pass()
    out = {'N': N, 'M': M, 'engine': dgp.engine, 'stage_s': t_stage, 'acc_error_gsa_s': t_acc,
           'acc_phases': acc_phases, 'acc_peak_above_held_gib': acc_peak,
           'device': torch.cuda.get_device_name(on) if cuda else 'cpu',
           'card': _card() if cuda else None,
           'S1_first3': [round(acc['S']['first_order'][m], 4) for m in range(min(3, M))],
           'T1_first3': [round(acc['T']['first_order'][m], 5) for m in range(min(3, M))]}
    if warm:
        again, t_warm, warm_phases, _ = card_pass()
        out.update(warm_error_gsa_s=t_warm, warm_phases=warm_phases,
                   warm_max_abs_dS=max(abs(acc['S'][k][m] - again['S'][k][m])
                                       for k in KINDS for m in range(M)))
    out['oracle'] = bool(oracle)
    if not oracle:
        return out
    n = min(N, ORACLE_MAX_N)
    if n < N:
        X, dgp = X[:n], DistributedGP(n, on, engine=dgp.engine)
        x_dev, y_dev = dgp.stage(X, Y[:n])
        acc = dgp.sobol_indices(ls, s2, noise, x_dev, y_dev, X, **options)
    out['oracle_N'] = n
    with torch.no_grad():
        alpha, _ = dgp.posterior_alpha(ls, s2, noise, x_dev, y_dev)
        if dgp.plan is not None:
            alpha = _from_stored_t(dgp.plan, alpha)
        alpha = alpha[:, 0].cpu().numpy()
    t0 = time.perf_counter()
    cpu = cpu_oracle(X, alpha, ls, s2, noise, n_chunk)
    out['cpu_oracle_s'] = time.perf_counter() - t0
    V, T = cpu['V'], cpu['T']
    dS = dT = dT2 = 0.0
    for i, k in enumerate(KINDS):
        for m in range(M):
            s = V[1 + i * M + m] / V[0]
            dS = max(dS, abs(acc['S'][k][m] - (1.0 - s if k == 'total' else s)))
            t = acc['T'][k][m]
            dT = max(dT, abs(t - T[1 + i * M + m]))
            dT2 = max(dT2, abs(t * t - T[1 + i * M + m] ** 2))
    out.update(max_abs_dS_vs_cpu_f64=dS, max_abs_dT_vs_cpu_f64=dT,
               max_abs_dT2_vs_cpu_f64=dT2, max_T2=float(np.max(T[1:] ** 2)))
    return out


def main(argv: Sequence[str] = ()) -> Dict[str, Any]:
    """Run on the card and print the record as one JSON line."""
    args = list(argv)
    numbers = [int(a) for a in args[:4]]
    extra = [MIXED[args[4]]] if len(args) > 4 else []
    out = run(*numbers, *extra, *(int(a) for a in args[5:7]))
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
