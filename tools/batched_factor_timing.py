#!/usr/bin/env python3
"""Time, on one NVIDIA GPU, a batch of Cholesky factorizations and of
inverses from the factor (torch's route for a batch: MAGMA's batched
kernels) against the same matrices one at a time (cuSOLVER), by order and
dtype; then one ExactLML value+grad of a batch of B float32 problems at
N=4096, M=30 against B single ones. The readings are why ExactLML
factorizes and differentiates each member of a batch on its own.

    python3 tools/batched_factor_timing.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def timed(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def factorizations():
    for dtype in (torch.float32, torch.float64):
        for N in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
            B = 6 if N <= 4096 else 3
            A = torch.randn(B, N, N, device='cuda', dtype=dtype)
            K = A @ A.mT / N + torch.eye(N, device='cuda', dtype=dtype)
            chol = torch.linalg.cholesky(K)
            r = [timed(lambda: torch.linalg.cholesky_ex(K)),
                 timed(lambda: [torch.linalg.cholesky_ex(K[i]) for i in range(B)]),
                 timed(lambda: torch.cholesky_inverse(chol)),
                 timed(lambda: [torch.cholesky_inverse(chol[i]) for i in range(B)])]
            print(f'{dtype} N={N} B={B}: cholesky_ex batched {r[0]:.3f} looped {r[1]:.3f} ms; '
                  f'cholesky_inverse batched {r[2]:.3f} looped {r[3]:.3f} ms', flush=True)
            del A, K, chol


def value_and_grad(N: int = 4096, M: int = 30):
    from romcomma_tpu_torch.models import gp
    g = torch.Generator().manual_seed(0)

    def step(ls, s2, noise, x, y):
        leaves = [t.clone().requires_grad_(True) for t in (ls, s2, noise)]
        torch.autograd.grad(gp.ExactLML.apply(*leaves, x, y).sum(), leaves)

    for B in (1, 2, 6):
        x = torch.randn(B, N, M, generator=g).cuda()
        y = torch.sin(torch.randn(B, N, generator=g)).cuda()
        p = (torch.full((B, M), 3.0, device='cuda'), torch.ones(B, device='cuda'),
             torch.full((B,), 0.01, device='cuda'), x, y)
        batched = timed(lambda: step(*p))
        singles = timed(lambda: [step(*(t[b] for t in p)) for b in range(B)])
        print(f'ExactLML value+grad, B={B}, N={N}, float32: batched {batched:.2f} ms; {B} single '
              f'{singles:.2f} ms', flush=True)


if __name__ == '__main__':
    if not torch.cuda.is_available():
        sys.exit('batched_factor_timing: no CUDA device')
    factorizations()
    value_and_grad()
