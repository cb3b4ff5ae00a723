#!/usr/bin/env python3
"""Where the north star's float32 descents end on one card, by arithmetic.

The north star's problem (``north_star.problem``, N=20000, M=30 by default)
descended in float32 from its start (ls 2, s2 1, noise 0.05) on:

  - 'cyclic2' with romcomma_tpu's float32 arithmetic: the gram, its noise,
    the factor, the solves and the value in float32, dLML/ds2 the engine's
    reduction of sum(Bbar o Knn) (``Float32LML`` below; the port's
    ``MeshLML`` computes so over several ranks);
  - 'cyclic2' as the port runs it on one card (``parallel.distributed.
    MeshLML``: the float32 gram through the kernel in strips written into a
    float64 gram, the rest in float64, dLML/ds2 from Euler's identity);
  - the same with dLML/ds2 the engine's float64 reduction of
    sum(Bbar o Knn) (``EngineDs2`` below);
  - engine='upper' (``ExactLML``, all float32);

each followed by a float64 descent on engine='upper' warm-started from its
optimum. Prints one JSON line per route: iterations, scipy's stop reason,
the LML, S1_first3, the seconds, the optimum (ls, s2, noise, each float32
value printed in full), and the float64 descent's iterations, LML and
S1_first3. It needs a CUDA device (~5 minutes on one H100 at N=20000).

    python3 tools/north_star_descents.py [N] [M]
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path

os.environ['ROMCOMMA_X64'] = '0'          # float32 training: the kernel's route
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(N: int = 20000, M: int = 30):
    import numpy as np
    import torch

    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.ops import gram_kernels, lbfgs
    from romcomma_tpu_torch.parallel import distributed

    class Float32LML(torch.autograd.Function):
        """romcomma_tpu's float32 arithmetic over an engine."""

        @staticmethod
        def forward(ctx, ls, s2, noise, x, y, engine):
            F = engine.chol(engine.gram(x, ls, s2, noise))
            z = engine.fwd(F, y)
            alpha = engine.bwd(F, z)
            value = (-0.5 * torch.sum(z * z) - engine.logdiag(F)
                     - 0.5 * engine.plan.N * math.log(2.0 * math.pi))
            ctx.engine = engine
            ctx.save_for_backward(ls, s2, noise, x, engine.residual(F), alpha)
            return torch.where(torch.isfinite(value), value, -torch.inf)

        @staticmethod
        def backward(ctx, gbar):
            ls, s2, noise, x, R, alpha = ctx.saved_tensors
            dls, ds2, dnoise = ctx.engine.grads(R, alpha, x, ls, s2, noise)
            return gbar * dls, gbar * ds2, gbar * dnoise, None, None, None

    class EngineDs2(distributed.MeshLML):
        """The port's one-card arithmetic, dLML/ds2 from the engine."""

        @staticmethod
        def backward(ctx, gbar):
            ls, s2, noise, x, R, alpha, _ = ctx.saved_tensors
            grads = ctx.engine.grads(R, alpha, x, ls, s2, noise)
            return tuple((gbar * g).to(x.dtype) for g in grads) + (None, None, None)

    if not torch.cuda.is_available():
        raise RuntimeError('the descents are measured on a CUDA device, and there is none')
    print(north_star._card(), torch.__version__, torch.version.cuda, flush=True)
    gram_kernels.build()
    X, Y = north_star.problem(N, M)
    stops = []
    minimize = lbfgs.minimize

    def recorded(*args, **kwargs):
        result = minimize(*args, **kwargs)
        stops.append(result.message)
        return result

    lbfgs.minimize = recorded

    def descent(engine, dtype, start):
        dgp = distributed.DistributedGP(N, 'cuda', dtype=dtype, engine=engine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hypers, lml, iterations = dgp.calibrate(X, Y, *start, maxiter=5000)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        x, y = dgp.stage(X, Y)
        S = dgp.sobol_indices(*hypers, x, y, X, kind='first_order')
        return hypers, {'iters': int(iterations), 'stop': stops[-1], 'lml': float(lml),
                        'S1_first3': [round(S[m], 4) for m in range(3)], 's': seconds,
                        'ls': hypers[0].tolist(), 's2': hypers[1].item(),
                        'noise': hypers[2].item()}

    port = distributed.MeshLML
    for route, engine, arithmetic in (("'cyclic2', romcomma_tpu's float32", 'cyclic2', Float32LML),
                                      ("'cyclic2', the port's", 'cyclic2', port),
                                      ("'cyclic2', the port's with the engine's ds2", 'cyclic2',
                                       EngineDs2),
                                      ("'upper', float32", 'upper', port)):
        distributed.MeshLML = arithmetic
        try:
            hypers, record = descent(engine, np.float32, (np.full(M, 2.0), 1.0, 0.05))
        finally:
            distributed.MeshLML = port
        _, polished = descent('upper', np.float64, tuple(h.double() for h in hypers))
        record['float64 descent from it'] = {k: polished[k] for k in ('iters', 'lml', 'S1_first3')}
        print(json.dumps({'route': route, 'N': N, 'M': M} | record), flush=True)
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main(*[int(a) for a in sys.argv[1:]])
