#!/usr/bin/env python3
"""Time, on one NVIDIA GPU, a batch of Cholesky factorizations and of
inverses from the factor (torch's route for a batch: MAGMA's batched
kernels) against the same matrices one at a time (cuSOLVER), by order and
dtype; then one ExactLML value+grad of a batch of B float32 problems at
N=4096, M=30 against B single ones. The readings are why ExactLML
factorizes and differentiates each member of a batch on its own.

    python3 tools/batched_factor_timing.py

With ``--inverse``, instead: K^-1 from one factor by
``ops.linalg.cho_inverse_lower_`` (potri's algorithm in the factor's buffer)
against ``torch.cholesky_inverse``, at the covariant orders (L N = 44280,
24576, 12288, float64) and the small route's (3800, float32): CUDA-event ms,
TFLOP/s over potri's 2n^3/3, the memory each allocates past the factor, and
the helper's lower triangle against K^-1 columns by cholesky_solve.

    python3 tools/batched_factor_timing.py --inverse
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


def device_ms(fn, setup=lambda: None, reps: int = 3) -> list:
    """CUDA-event ms of fn() after setup(), each of reps runs after one warm."""
    times = []
    for r in range(reps + 1):
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end))
    return times


def inverses(shapes=((44280, torch.float64), (24576, torch.float64), (12288, torch.float64),
                     (3800, torch.float32))):
    from romcomma_tpu_torch.ops import linalg
    for n, dtype in shapes:
        A = torch.randn(n, 256, device='cuda', dtype=dtype)
        K = torch.addmm(torch.eye(n, device='cuda', dtype=dtype), A, A.T, alpha=1 / 256)
        chol = torch.linalg.cholesky(K)
        del A, K
        work = torch.empty_like(chol)
        flops = 2 * n ** 3 / 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        in_place = device_ms(lambda: linalg.cho_inverse_lower_(work), lambda: work.copy_(chol))
        in_place_bytes = torch.cuda.max_memory_allocated() - base
        columns = torch.linspace(0, n - 1, 8, device='cuda').long()
        E = torch.zeros(n, 8, device='cuda', dtype=dtype)
        E[columns, torch.arange(8, device='cuda')] = 1.0
        want = torch.cholesky_solve(E, chol)
        gap = max(((work[c:, c] - want[c:, k]).abs().max() / want[:, k].abs().max()).item()
                  for k, c in enumerate(columns.tolist()))
        del work, E, want
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        library = device_ms(lambda: torch.cholesky_inverse(chol))
        library_bytes = torch.cuda.max_memory_allocated() - base
        route = 'in place' if n * n < linalg.IN_PLACE_MAX_ELEMENTS else 'cholesky_inverse'
        print(f'{dtype} n={n}: cho_inverse_lower_ ({route}) ms {[round(t, 1) for t in in_place]} '
              f'({flops / min(in_place) / 1e9:.1f} TFLOP/s over 2n^3/3), '
              f'{in_place_bytes / 1e9:.3f} GB past the factor, column gap {gap:.2e}; '
              f'cholesky_inverse ms {[round(t, 1) for t in library]} '
              f'({flops / min(library) / 1e9:.1f} TFLOP/s over 2n^3/3; '
              f'{3 * flops / min(library) / 1e9:.1f} over 2n^3), '
              f'{library_bytes / 1e9:.3f} GB past the factor', flush=True)
        del chol
        torch.cuda.empty_cache()


if __name__ == '__main__':
    if not torch.cuda.is_available():
        sys.exit('batched_factor_timing: no CUDA device')
    if '--inverse' in sys.argv[1:]:
        inverses()
    else:
        factorizations()
        value_and_grad()
