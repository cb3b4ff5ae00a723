"""Head to head on one card: romcomma_tpu's three ``DistributedGP`` engines,
'upper', 'cyclic2' and 'cyclic', each forced onto one device, over N.

Counterpart of ``benchmarks/cyclic2_engine.py``: the same problem (seed 0,
X ~ N(0, 1) of shape (N, M), Y = sin(x0) + 0.1 eps), the same point (ls 2,
s2 1, noise 0.05), float32, one untimed value+grad and ``reps`` timed ones
per engine, and the same fields per engine (``valgrad_s`` the fastest,
``first_s``, ``value``, ``grad_l2``); several N in one process, where the
reference takes one, plus every timed value+grad, the unit-gram launches of
one, the peak device memory above what was held before it, and the card's
name and power limit. On one device the collectives of 'cyclic2' and
'cyclic' are the identity, so the numbers compare the engines' structure:
'upper' is ExactLML (three (N, N) buffers, cuSOLVER's factor and
``cholesky_inverse``), 'cyclic2' the deferred super panels, the in-place
inverse and the pair tiles, 'cyclic' the right-looking block factor.

    python -m romcomma_tpu_torch.cyclic2_engine [Ns] [M] [reps] [engines]

``Ns`` is a comma list (default 12288,16384,20000,32768), ``engines`` a
comma list of upper,cyclic2,cyclic (default all three). The command needs a
CUDA device and prints one JSON line.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from romcomma_tpu_torch.north_star import _card, _synchronize
from romcomma_tpu_torch.ops import gram_kernels
from romcomma_tpu_torch.parallel.distributed import DistributedGP

NS = (12288, 16384, 20000, 32768)
ENGINES = ('upper', 'cyclic2', 'cyclic')


def problem(N: int, M: int):
    """benchmarks/cyclic2_engine.py's data."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, M))
    return X, np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))


def run(Ns: Sequence[int] = NS, M: int = 30, reps: int = 3, engines: Sequence[str] = ENGINES,
        on: str = 'cuda') -> Dict[str, Any]:
    """The record: {'M', 'reps', 'device', 'card', str(N): {engine: ...}}.
    ``on`` is 'cuda' (required there) or 'cpu', where the device numbers read
    None."""
    on = torch.device(on)
    cuda = on.type == 'cuda'
    if cuda and not torch.cuda.is_available():
        raise RuntimeError('the engines are measured on a CUDA device, and there is none')
    out: Dict[str, Any] = {'M': M, 'reps': reps, 'dtype': 'float32',
                           'device': torch.cuda.get_device_name(on) if cuda else 'cpu',
                           'card': _card() if cuda else None}
    point = (np.full(M, 2.0), 1.0, 0.05)
    for N in Ns:
        X, Y = problem(N, M)
        row = {}
        for name in engines:
            dgp = DistributedGP(N, on, dtype=np.float32, engine=name)
            if dgp.engine != name:
                raise RuntimeError(f'DistributedGP took {dgp.engine!r} for engine={name!r}')
            x, y = dgp.stage(X, Y)

            def valgrad():
                p = [torch.tensor(v, dtype=torch.float32, device=on, requires_grad=True)
                     for v in point]
                _synchronize(on)
                t0 = time.perf_counter()
                value = dgp.lml(*p, x, y)
                grads = torch.autograd.grad(value, p)
                _synchronize(on)
                return time.perf_counter() - t0, value, grads

            if cuda:
                held = torch.cuda.memory_allocated(on)
                torch.cuda.reset_peak_memory_stats(on)
            first_s, value, grads = valgrad()
            launches = gram_kernels.LAUNCHES
            times = [valgrad()[0] for _ in range(reps)]
            row[name] = {
                'valgrad_s': min(times), 'valgrad_s_all': times, 'first_s': first_s,
                'value': value.item(),
                'grad_l2': math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads)),
                'launches_per_valgrad': (gram_kernels.LAUNCHES - launches) / reps,
                'peak_above_held_gib': ((torch.cuda.max_memory_allocated(on) - held) / 2 ** 30
                                        if cuda else None)}
            del dgp, x, y, value, grads
            if cuda:
                torch.cuda.empty_cache()
        out[str(N)] = row
    return out


def main(argv: Sequence[str] = ()) -> Dict[str, Any]:
    """Run the head to head on the card and print its record as one JSON line."""
    args = list(argv)
    out = run(tuple(int(n) for n in args[0].split(',')) if args else NS,
              int(args[1]) if len(args) > 1 else 30,
              int(args[2]) if len(args) > 2 else 3,
              tuple(args[3].split(',')) if len(args) > 3 else ENGINES)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
