#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port, romcomma_tpu_torch, on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its result and its time; none catches its own failure):
  1. the card, torch and CUDA;
  2. the unit-gram kernel's build from csrc/unit_gram.cu (nvcc, sm_90a);
  3. the kernel against its plain version, forward and backward, at the main
     path's shapes (u is v) and at ragged and two-operand ones; then both
     versions' times at the main path's shapes (CUDA events, 50 samples of
     10 back-to-back calls each after warm-up), the kernels' device time
     (torch.profiler), the bound, and the wrapper's host time per call;
  4. the main path at full size through the user entry points:
     sample OAKLEY2004 at N=8192, M=30 -> into_K_folds(2) -> run.gpr (variant
     MOGP, isotropic then anisotropic, maxiter=50, tested), in float32, so the
     training grams go through the kernel; then the checks that the run went
     through the kernel and that its LMLs match the float64 plain path;
  5. a profile of one float32 LML value-and-gradient at N=4096 and N=8192.

The last two lines of standard output are the kernels' JSON record and the
device's. Exits non-zero, printing no result, where there is no CUDA device
or no checkout around the script.
"""

from __future__ import annotations

import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20241016
N, M, K, MAXITER = 8192, 30, 2, 50
#: (A, B, M, u is v). The training grams of the main path have u is v.
KERNEL_SHAPES = [(37, 61, 5, False), (4097, 4095, 30, False), (4096, 4096, 30, False),
                 (4096, 4096, 30, True), (8192, 8192, 30, True)]
TIMED_SHAPES = [(4096, 4096, 30), (8192, 8192, 30)]
TIMING_SAMPLES, CALLS_PER_SAMPLE = 50, 10

#: The H100 SXM's published peaks (NVIDIA data sheet, dense): HBM bytes/s,
#: TF32 tensor-core and float32 CUDA-core flop/s.
HBM_BYTES_PER_S, TF32_FLOPS, F32_FLOPS = 3.35e12, 495e12, 67e12

#: Kernel against plain, forward: both sides form |u|^2 + |v|^2 - 2 u.v in
#: float32 from inputs whose squared norms stay below ~10, so E = exp(-d/2)
#: differs by a few float32 ulps of 10 at most: the TPU kernel's own 2e-6.
VALUE_TOL = 2e-6
#: Backward: float32 sums of up to 8192 products taken in another order on
#: each side, held relative to the largest gradient entry.
GRAD_RTOL = 1e-4


def require(condition, message):
    """A check that stays under python -O."""
    if not condition:
        raise RuntimeError(f'chip_smoke check failed: {message}')


def phase(title: str):
    print(f'\n== {title}', flush=True)
    return time.perf_counter()


def card_line() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def unit_inputs(torch, A, B, M_, seed, shared=False):
    """u, v with squared distances of order one, so E spans (0, 1]; v is u
    when shared."""
    g = torch.Generator().manual_seed(seed)
    scale = 1.5 / math.sqrt(M_)
    u = (torch.randn(A, M_, generator=g) * scale).cuda()
    return u, u if shared else (torch.randn(B, M_, generator=g) * scale).cuda()


def spread_ms(torch, fns, samples=TIMING_SAMPLES, calls=CALLS_PER_SAMPLE, warmup=3):
    """(min, median, max) ms per call of each function: CUDA events around
    `calls` back-to-back calls, `samples` times, the functions in turns."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(samples):
        for fn, out in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / calls)
    return [(min(t), statistics.median(t), max(t)) for t in times]


#: The unit-gram wrapper's kernels, by name: the pack pre-pass and the gram.
KERNEL_NAMES = ('pack_kernel', 'unit_gram_kernel')


def kernel_device_ms(torch, fn, calls=20):
    """Device time per call of the unit-gram kernels that fn launches, from
    torch.profiler: free of the host's launch gaps."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and any(k in e.key for k in KERNEL_NAMES)) / calls / 1e3


def host_us_per_call(torch, fn, calls=2000):
    """Host time per call of fn, where the card finishes each call sooner
    than the host issues the next: the wrapper's own cost."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def forward_bound_ms(A, B, M_, shared):
    """The least time the H100 could take for one forward: each input read
    once and E written once at the HBM rate, against the kernel's operations
    at their type's peak (3xTF32 cross term 3 * 2 A B M on the tensor cores;
    about 8 float32 operations per output in the epilogue)."""
    stored = 4 * (A * B + (A if shared else A + B) * M_)
    operations = max(3 * 2 * A * B * M_ / TF32_FLOPS, 8 * A * B / F32_FLOPS)
    seconds = stored / HBM_BYTES_PER_S
    return 1e3 * max(seconds, operations), 'bytes' if seconds >= operations else 'operations'


def backward_bound_ms(A, B):
    """The backward's least time: gbar and E read once (2 A B 4 bytes)."""
    return 1e3 * 8 * A * B / HBM_BYTES_PER_S


def check_kernel(torch, gram_kernels):
    """Phase 3: forward and backward against the plain version; times."""
    max_err = 0.0
    for A, B, M_, shared in KERNEL_SHAPES:
        u, v = unit_inputs(torch, A, B, M_, seed=A, shared=shared)
        got = gram_kernels.unit_gram_cuda(u, v)
        torch.cuda.synchronize()
        want = gram_kernels.unit_gram_plain(u, v)
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= VALUE_TOL, (A, B, M_, shared, err))
        gbar = torch.randn(A, B, generator=torch.Generator().manual_seed(B)).cuda()
        grads = []
        for fn in (gram_kernels.unit_gram, gram_kernels.unit_gram_plain):
            uu = u.clone().requires_grad_(True)
            vv = uu if shared else v.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(torch.sum(fn(uu, vv) * gbar),
                                             (uu,) if shared else (uu, vv)))
        grad_err = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(*grads))
        require(grad_err <= GRAD_RTOL, (A, B, M_, shared, grad_err))
        max_err = max(max_err, err)
        print(f'({A}, {B}, {M_}{", u is v" if shared else ""}): forward max |kernel - plain| = '
              f'{err:.3e} (tol {VALUE_TOL}); backward max error / max |grad| = {grad_err:.3e} '
              f'(tol {GRAD_RTOL})', flush=True)
    times = {}
    for A, B, M_ in TIMED_SHAPES:
        u, _ = unit_inputs(torch, A, B, M_, seed=7, shared=True)
        ug = u.clone().requires_grad_(True)
        gbar = torch.ones(A, B, device='cuda')

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(torch.sum(fn(ug, ug) * gbar), (ug,))

        # Each version timed on its own: a plain call between kernel samples
        # leaves the L2 full of its dirty output for the kernel to write back.
        (kernel,), (plain,) = (spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, u)]),
                               spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, u)]))
        (kernel_fb,), (plain_fb,) = (spread_ms(torch, [fwd_bwd(gram_kernels.unit_gram)]),
                                     spread_ms(torch, [fwd_bwd(gram_kernels.unit_gram_plain)]))
        device = kernel_device_ms(torch, lambda: gram_kernels.unit_gram_cuda(u, u))
        bound, bound_by = forward_bound_ms(A, B, M_, shared=True)
        times[(A, B, M_)] = (kernel[1], plain[1], bound, bound_by)
        print(f'({A}, {B}, {M_}, u is v) ms per call, min / median / max of {TIMING_SAMPLES} '
              f'samples of {CALLS_PER_SAMPLE} calls: forward kernel '
              f'{kernel[0]:.4f} / {kernel[1]:.4f} / {kernel[2]:.4f}, plain '
              f'{plain[0]:.4f} / {plain[1]:.4f} / {plain[2]:.4f}; forward+backward kernel '
              f'{kernel_fb[0]:.4f} / {kernel_fb[1]:.4f} / {kernel_fb[2]:.4f}, plain '
              f'{plain_fb[0]:.4f} / {plain_fb[1]:.4f} / {plain_fb[2]:.4f}', flush=True)
        print(f'({A}, {B}, {M_}) forward bound {bound:.4f} ms ({bound_by}); kernel median at '
              f'{bound / kernel[1]:.3f} of it; the kernels\' device time per call (pack + gram, '
              f'torch.profiler) {device:.4f} ms, at {bound / device:.3f}. Backward bound '
              f'{backward_bound_ms(A, B):.4f} ms (bytes); backward alone ~'
              f'{kernel_fb[1] - kernel[1]:.4f} ms', flush=True)
    u, _ = unit_inputs(torch, 128, 128, 30, seed=7, shared=True)
    print(f'wrapper host time per call at (128, 128, 30, u is v): '
          f'{host_us_per_call(torch, lambda: gram_kernels.unit_gram_cuda(u, u)):.2f} us', flush=True)
    return max_err, times


def main_path(torch, user, gram_kernels):
    """Phase 4: sample -> k-fold -> run.gpr at full size, through the kernel."""
    from romcomma_tpu_torch.models import gp, params
    from romcomma_tpu_torch.models.gpr import MOGP
    from romcomma_tpu_torch.data.storage import Fold

    root = ROOT / 'build' / 'chip_smoke'
    shutil.rmtree(root, ignore_errors=True)
    np_seed(SEED)
    noise = user.sample.GaussianNoise.Variance(L=len(user.functions.OAKLEY2004), magnitude=0.04)
    repo = user.sample.Function(root, user.sample.DOE.latin_hypercube, user.functions.OAKLEY2004,
                                N=N, M=M, noise_variance=noise, overwrite_existing=True,
                                seed=SEED).repo.into_K_folds(K)
    gram_kernels.LAUNCHES = 0
    t0 = time.perf_counter()
    names = user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=None,
                         maxiter=MAXITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gram_kernels.LAUNCHES
    print(f'run.gpr: {seconds:.2f} s, models {names}, folds {list(repo.folds)}, '
          f'unit-gram kernel launches {launches}', flush=True)
    require(launches > 0, 'the main path never launched the unit-gram kernel')
    require(names == ['gpr.v.i', 'gpr.v.a'], names)
    worst = 0.0
    for k in repo.folds:
        fold = Fold(repo, k)
        for name in names:
            folder = fold.folder / name
            stored = json.loads((folder / 'meta.json').read_text())['result']
            require((folder / 'test.csv').is_file() and (folder / 'test_summary.csv').is_file(),
                    f'{folder} has no test.csv or test_summary.csv')
            model = MOGP(name, fold, is_read=True, is_covariant=False,
                         is_isotropic=name.endswith('.i'))
            raw = model._variant_raw()
            with torch.no_grad():
                lml32 = gp.lml_variant(raw, model._tensor(model.X), model._tensor(model.Y))
                raw64 = {n: t.double() for n, t in raw.items()}
                lml64 = gp.lml_variant(raw64, model._tensor(model.X, torch.float64),
                                       model._tensor(model.Y, torch.float64))
                c = params.variant_constrain(raw64)
            require(bool(torch.isfinite(lml32).all() and torch.isfinite(lml64).all()), (k, name, stored))
            # First-order error of a float32 LML: the float32 gram and Cholesky
            # perturb K by ~eps32 * s2 per entry, which moves log|K| and
            # y'K^-1 y by up to ~N * eps32 * s2 / noise; 10x that is the bound.
            bound = 10 * model.N * 1.1920929e-07 * (c['variance'] / c['noise'] + 1.0)
            error = (lml32.double() - lml64).abs()
            worst = max(worst, (error / bound).max().item())
            print(f'fold.{k} {name} N={model.N}: LML f32 kernel {lml32.tolist()} vs f64 plain '
                  f'{lml64.tolist()}; |diff| {error.tolist()} bound {bound.tolist()}; {stored}',
                  flush=True)
            require(bool((error <= bound).all()), (k, name, error, bound))
    summary = repo.folder / 'gpr.v.a' / 'test_summary.csv'
    print(f'test_summary (anisotropic, all folds):\n{summary.read_text()}', flush=True)
    return launches, seconds, worst


def np_seed(seed: int):
    import numpy as np
    np.random.seed(seed)
    random.seed(seed)


def profile_value_and_grad(torch):
    """Phase 5: where one float32 LML value-and-gradient spends device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from romcomma_tpu_torch.models import gp, params
    rng = np.random.default_rng(SEED)
    for n in (4096, 8192):
        x = torch.tensor(rng.normal(size=(n, M)), dtype=torch.float32, device='cuda')
        y = torch.tensor(np.sin(x[:, 0].cpu().numpy()), dtype=torch.float32, device='cuda')
        raw = params.variant_select(params.variant_init(np.ones(1), np.full((1, M), 3.0),
                                                        np.full(1, 0.01)), 0)

        def step():
            p = {name: t.clone().requires_grad_(True) for name, t in raw.items()}
            value = gp.lml_single(p, x, y)
            torch.autograd.grad(value, list(p.values()))

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        gram = sum(e.self_device_time_total for e in kernels
                   if any(k in e.key for k in KERNEL_NAMES)) / 1e3
        print(f'N={n}: one LML value+grad {wall:.2f} ms wall; device busy {busy:.2f} ms '
              f'(idle share {max(0.0, 1 - busy / wall):.3f}); unit-gram kernels (pack + gram) '
              f'{gram:.3f} ms; top kernels by device time:', flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f'    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}',
                  flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on a GPU only.', file=sys.stderr)
        return 1
    os.environ['ROMCOMMA_X64'] = '0'          # float32 training: the kernel's route
    sys.path.insert(0, str(ROOT))
    from romcomma_tpu_torch import user
    from romcomma_tpu_torch.base.definitions import FLOAT
    from romcomma_tpu_torch.ops import gram_kernels
    require(FLOAT().itemsize == 4, 'ROMCOMMA_X64=0 was read too late')

    t = phase('1. card')
    card = card_line()
    print(f'{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}', flush=True)

    t = phase('2. unit-gram kernel build')
    library = gram_kernels.build()
    gram_kernels._library()
    print(f'{library.relative_to(ROOT)} in {time.perf_counter() - t:.2f} s', flush=True)

    t = phase('3. kernel against plain')
    max_err, times = check_kernel(torch, gram_kernels)
    print(f'phase 3: {time.perf_counter() - t:.2f} s', flush=True)

    t = phase(f'4. main path: OAKLEY2004 N={N} M={M} K={K}, run.gpr maxiter={MAXITER}, float32')
    launches, seconds, worst = main_path(torch, user, gram_kernels)
    print(f'phase 4: {time.perf_counter() - t:.2f} s (run.gpr {seconds:.2f} s); '
          f'worst LML error / bound {worst:.3e}', flush=True)

    t = phase('5. profile of one float32 LML value-and-gradient')
    profile_value_and_grad(torch)
    print(f'phase 5: {time.perf_counter() - t:.2f} s', flush=True)

    kernel_ms, plain_ms, bound_ms, bound_by = times[(8192, 8192, 30)]
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'unit_gram', 'route': 'cuda',
        'source': 'romcomma_tpu_torch/csrc/unit_gram.cu',
        'replaces': 'romcomma_tpu/ops/pallas_kernels.py:59',
        'launches': launches, 'max_abs_err': max_err,
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': None}]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
