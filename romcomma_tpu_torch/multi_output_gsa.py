"""Several outputs' Sobol' indices on the large route: ONE stacked interval
pass for all L outputs against the per-output loop.

Counterpart of ``benchmarks/multi_output_gsa.py``: the same problem (seed 0,
X ~ N(0, 1) of shape (N, M), three outputs of distinct structure plus
0.1 eps), the same hyperparameters (ls 2 + 0.2 l, s2 1, noise 0.05), both
kinds, each route run twice (cold, then the reported warm pass) and the
same fields (``t_stacked_s``, ``t_sequential_s``, ``speedup``,
``max_dS_vs_sequential`` and, with errors, ``max_dT_vs_sequential``), plus
the peak device memory of each route and the card's name and power limit.
The stacked route is ``DistributedGP.sobol_indices`` with (L, M)
lengthscales (``_sobol_indices_multi[_error]``), the loop one call per
output. ``DistributedGP`` is built as the large route builds it
(``dense_kernels=True``: 'upper' below ``CYCLIC2_SINGLE_CHIP_MIN_N`` rows,
'cyclic2' from there), where the reference takes its default engine; the
posterior solves are each route's, the indices float64.

    python -m romcomma_tpu_torch.multi_output_gsa [N] [M] [L] [mode]

``mode``: 'all' (default: stacked and loop), 'stacked', 'error_all' or
'error' (the same with W/T errors). The command needs a CUDA device and
prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from romcomma_tpu_torch.north_star import _card, _synchronize
from romcomma_tpu_torch.parallel.distributed import DistributedGP

KINDS = ('first_order', 'total')


def problem(N: int, M: int, L: int):
    """benchmarks/multi_output_gsa.py's data: each output's leading inputs
    differ, so each output's indices do."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, M))
    Y = np.stack([np.sin(X[:, 0]) + 0.5 * X[:, 1] ** 2,
                  X[:, 0] * X[:, 1] + np.sin(X[:, 2]),
                  np.cos(X[:, 1]) + 0.3 * X[:, 3] ** 2][:L], axis=-1)
    return X, Y[:, :L] + 0.1 * rng.standard_normal((N, L))


def run(N: int = 8192, M: int = 30, L: int = 3, mode: str = 'all', on: str = 'cuda',
        n_chunk=None) -> Dict[str, Any]:
    """The record. ``on`` is 'cuda' (required there) or 'cpu', where the
    device numbers read None; ``n_chunk`` sets the calibrators' chunk."""
    on = torch.device(on)
    cuda = on.type == 'cuda'
    if cuda and not torch.cuda.is_available():
        raise RuntimeError('the GSA is measured on a CUDA device, and there is none')
    X, Y = problem(N, M, L)
    dgp = DistributedGP(N, on, dense_kernels=True)
    x_dev, y_dev = dgp.stage(X, Y)
    ls = np.stack([np.full(M, 2.0 + 0.2 * l) for l in range(L)])
    s2, noise = np.ones(L), np.full(L, 0.05)
    error = mode.startswith('error')
    options = dict(kind=KINDS, error=error, n_chunk=n_chunk)

    def S_of(r):
        return r['S'] if error else r

    def timed(call):
        """(the result of two calls, the second's seconds, the first's, the
        peak device memory above what was held, in GiB)."""
        if cuda:
            held = torch.cuda.memory_allocated(on)
            torch.cuda.reset_peak_memory_stats(on)
        seconds = []
        for _ in range(2):
            t0 = time.perf_counter()
            result = call()
            _synchronize(on)
            seconds.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated(on) - held) / 2 ** 30 if cuda else None
        return result, seconds[1], seconds[0], peak

    stacked, t_stacked, t_stacked_cold, stacked_peak = timed(
        lambda: dgp.sobol_indices(ls, s2, noise, x_dev, y_dev, X, **options))
    out = {'bench': 'multi_output_gsa', 'N': N, 'M': M, 'L': L, 'error': error,
           'engine': dgp.engine, 't_stacked_s': t_stacked, 't_stacked_cold_s': t_stacked_cold,
           'stacked_timings': dict(dgp.last_gsa_timings), 'stacked_peak_gib': stacked_peak,
           'S1_per_output': [[round(S_of(stacked[l])['first_order'][m], 4) for m in range(3)]
                             for l in range(L)],
           'device': torch.cuda.get_device_name(on) if cuda else 'cpu',
           'card': _card() if cuda else None}
    if mode in ('all', 'error_all'):
        seq, t_seq, t_seq_cold, seq_peak = timed(lambda: [
            dgp.sobol_indices(ls[l], s2[l], noise[l], x_dev, y_dev[:, l:l + 1], X, **options)
            for l in range(L)])
        out.update({'t_sequential_s': t_seq, 't_sequential_cold_s': t_seq_cold,
                    'sequential_peak_gib': seq_peak, 'speedup': t_seq / t_stacked,
                    'max_dS_vs_sequential': max(
                        abs(S_of(stacked[l])[k][m] - S_of(seq[l])[k][m])
                        for l in range(L) for k in KINDS for m in range(M))})
        if error:
            out['max_dT_vs_sequential'] = max(abs(stacked[l]['T'][k][m] - seq[l]['T'][k][m])
                                              for l in range(L) for k in KINDS for m in range(M))
    return out


def main(argv: Sequence[str] = ()) -> Dict[str, Any]:
    """Run on the card and print the record as one JSON line."""
    args = list(argv)
    out = run(*(int(a) for a in args[:3]), *args[3:4])
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
