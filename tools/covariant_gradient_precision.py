#!/usr/bin/env python3
"""Where the float32 (F, noise_cov) gradient of the covariant chain loses its
accuracy, on one CUDA device: at L*N = 3 x 4096, M = 30, with phase 13c's
F (correlation 0.5) and noise covariance of chip_smoke.py, it prints each
float32 gradient's distance from float64 CovariantUpperLML's:

  - CovariantUpperLML (K^-1 from cholesky_inverse) and the covariant mesh
    on an NCCL group of this process (K^-1 as V V^T, V the in-place
    inverse of the factor: parallel.cyclic_deferred);
  - dF and dnoise reduced in float64 from the float64 alpha and each
    float32 K^-1: V V^T from the mesh's factor, cholesky_inverse, and
    L^-T L^-1 through a triangular solve, with each K^-1's own distance
    from the float64 one. The K^-1 whose dF lies far off is the one the
    error comes from; the reduction's share is the rest.

    python3 tools/covariant_gradient_precision.py

It needs a CUDA device and takes under a minute on one H100.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ['ROMCOMMA_X64'] = '0'
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N, M, L = 4096, 30, 3


def main():
    import numpy as np
    import torch

    import chip_smoke
    from romcomma_tpu_torch.models import gp
    from romcomma_tpu_torch.ops.gram import rbf_gram_covariant_unit
    from romcomma_tpu_torch.parallel.covariant_mesh import DistributedCovariantGP
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    chip_smoke.require(torch.cuda.is_available(), 'no CUDA device')
    print(chip_smoke.card_line(), torch.__version__, torch.version.cuda, flush=True)
    rng = np.random.default_rng(chip_smoke.SEED)
    X = rng.uniform(0, 1, (N, M))
    Y = np.column_stack([np.sin(3 * X[:, 0]) + X[:, 1], X[:, 2] ** 2, X[:, 0] * X[:, 3]])
    Y = Y + 0.03 * rng.standard_normal(Y.shape)
    d = np.sqrt([0.49, 0.93, 4.49])
    F = chip_smoke.COVARIANT_MESH_CORRELATION * np.outer(d, d) + (
        1.0 - chip_smoke.COVARIANT_MESH_CORRELATION) * np.diag(d * d)
    noise = np.diag([0.0011, 0.0018, 0.046])
    ls = np.full((L, M), 2.0)

    def tensors(dtype):
        return [torch.as_tensor(a, dtype=dtype, device='cuda') for a in (X, Y, ls, F, noise)]

    x64, y64, ls64, F64, noise64 = tensors(torch.float64)
    upper64 = gp.covariant_upper_lml(x64, ls64, y64)
    want = chip_smoke._covariant_value_and_grads(torch, upper64, F64, noise64)
    del upper64
    unit4 = rbf_gram_covariant_unit(x64, ls64)
    chol64 = torch.linalg.cholesky(gp._assemble(unit4, F64, noise64))
    Kinv64 = torch.cholesky_inverse(chol64)
    alpha = torch.cholesky_solve(y64.T.reshape(-1, 1), chol64)
    del chol64

    def reduced(Kinv):
        W = (alpha @ alpha.T - Kinv.double()).view(L, N, L, N)
        return [0.5 * (W * unit4).sum(dim=(1, 3)), 0.5 * W.diagonal(dim1=1, dim2=3).sum(-1)]

    def line(label, got, kinv=None):
        apart = chip_smoke._apart(got, want[1:])
        tail = '' if kinv is None else (
            f'; K^-1 max |diff| {(kinv.double() - Kinv64).abs().max().item():.3e} of max '
            f'|K^-1| {Kinv64.abs().max().item():.3e}')
        print(f'{label}: dF {apart[0]:.3e}, dnoise {apart[1]:.3e} from float64 (sizes '
              f'{want[1].abs().max().item():.3e}, {want[2].abs().max().item():.3e}){tail}',
              flush=True)

    x, y, ls32, F32, noise32 = tensors(torch.float32)
    line('CovariantUpperLML float32', chip_smoke._covariant_value_and_grads(
        torch, gp.covariant_upper_lml(x, ls32, y), F32, noise32)[1:])
    with chip_smoke.nccl_group(torch):
        dgp = DistributedCovariantGP(N, L, make_n_mesh(), dtype=np.float32)
        st = dgp.stage(x, y, ls32)
        line('covariant mesh float32', chip_smoke._covariant_value_and_grads(
            torch, dgp.lml_fn(st), F32, noise32)[1:])
        with torch.no_grad():
            U = dgp.engine.chol(dgp._gram(st, F32, noise32))
            V = dgp.engine.inv(U)
            Kinv = (V @ V.T)[:L * N, :L * N]    # one rank: stored order is global, padding last
            del U, V
    line('float64 reduction of the mesh\'s float32 V V^T', reduced(Kinv), Kinv)
    del Kinv
    chol32 = torch.linalg.cholesky(gp._assemble(unit4.float(), F32, noise32))
    Kinv = torch.cholesky_inverse(chol32)
    line('float64 reduction of float32 cholesky_inverse', reduced(Kinv), Kinv)
    Linv = torch.linalg.solve_triangular(chol32, torch.eye(L * N, device='cuda'), upper=False)
    Kinv = Linv.T @ Linv
    line('float64 reduction of float32 L^-T L^-1 (triangular solve, then a product)',
         reduced(Kinv), Kinv)


if __name__ == '__main__':
    main()
