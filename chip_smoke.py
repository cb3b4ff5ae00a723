#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port, romcomma_tpu_torch, on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its result and its time; none catches its own failure):
  1. the card, torch and CUDA;
  2. the unit-gram kernel's build from csrc/unit_gram.cu (nvcc, sm_90a);
  3. the kernel against its plain version, forward and backward, at the main
     path's shapes (u is v; the covariant path's stacked (L*N)^2 ones too) and
     at ragged and two-operand ones, and the covariant gram's one launch over
     stacked operands; then both versions' times at the main paths' shapes
     (phase 9's (8192^2, 10) among them; CUDA events, 50 samples of 10
     back-to-back calls each after warm-up),
     the kernels' device time (torch.profiler), the bound, and the wrapper's
     host time per call; and the forward's times at the covariant shapes;
     then the batched launch (one launch for a batch of grams) against its
     plain version and, bit for bit, against one launch per member, at the
     main path's batches (6, 4096^2, 30), (6, 5120^2, 30), (3, 8192^2, 30),
     a ragged two-operand one and the CLIs' (60, 3800^2, 30) and
     (18, 4000^2, 19), each timed against its members' single launches, with
     its bound;
  4. the main path at full size through the user entry points:
     sample OAKLEY2004 at N=8192, M=30 -> into_K_folds(2) -> run.gpr (variant
     MOGP, isotropic then anisotropic, maxiter=50, tested, fold_parallel=True:
     the two 4096-row folds' six descents in lockstep through one batched
     launch per evaluation, the improper fold alone), in float32, so the
     training grams go through the kernel; each fold group's time, launches
     and every descent's scipy stop and iterations; then the checks that the
     run went through the kernel and its batched launch and that its LMLs
     match the float64 plain path;
  5. a profile of one float32 LML value-and-gradient at N=4096 and N=8192;
  6. the GSA on the card: run.gsa (all three kinds, standard errors,
     non-partial T, float64, fold_parallel=True: the two 4096-row folds in
     one stacked pass) on phase 4's trained repository (3 folds,
     N = 4096, 4096, 8192, M=30, L=3), with the checks that every S/V/T/W
     is written and finite, the full slice's S has a unit diagonal, CLOSED S
     grows with m and T >= 0; each fold group's time and its V-pass /
     W-T-sweep / psi-solve split, the chunk counts, peak device memory, the
     top device kernels of one N=4096 fold (torch.profiler), and the stacked
     pass of the two 4096-row folds profiled beside one fold's; the card's
     factorized W/T sweep against its own per-slice path on an
     installation-size fold; then the port's
     installation test on the card, held within ULP_SPREADS of a one-ulp
     spread to its GSA on the CPU from the card's float64 inputs, to its
     own chunk loops against one chunk, to run.gsa on a copy of the trained
     tree on the CPU, and to the CPU's posterior and GSA from the card's
     float32 parameters;
  7. the covariant MOGP on phase 4's trained repository: run.gpr
     (is_covariant=True, warm-started from gpr.v.a, float32, L*N = 12288,
     12288, 24576, lengthscales frozen, so every descent runs
     CovariantUpperLML), with per-fold times, launches, scipy's stop reason
     and the float32 LML against the float64 plain LML; one value+grad
     profiled at L*N = 12288 and 24576, lengthscales frozen, and one at 12288
     with them trainable; at L*N = 12288, CovariantUpperLML's value and
     F/noise gradients in float32 and float64 held to float64 autograd within
     first-order limits from the measured cond(K);
     run.gsa(is_covariant=True) without errors, checked; then the
     installation test's size with the kernel covariance trained (F
     non-diagonal), its LML, gradient, predictions and GSA on the card held
     to the CPU's from the same float64 inputs;
  8. the large-N variant route (parallel.distributed.DistributedGP):
     a. the north star, romcomma_tpu_torch.north_star at N=20000, M=30,
        trained to convergence in float32 (its grams through the kernel) on
        its production route, 'cyclic2' on one card (romcomma_tpu's choice
        from N=16384), its S1 held to the problem's analytic indices, its
        optimum to romcomma_tpu's recorded LML and to a float64 descent
        (engine='upper') warm-started from it; the residual of its float64
        posterior, its per-phase times and peak memory by stage, one
        value+grad timed beside engine='upper''s streaming route (at
        NORTH_STAR_UPPER_OPTIMUM, where ExactLML float32 factorizes) and
        profiled by kernel and by op;
     b. run.gpr (variant, isotropic then anisotropic, maxiter=20, float32,
        tested) on OAKLEY2004 at N=10240, M=30, K=2: the two 5120-row folds
        take the small route and the improper 10240-row fold the large one
        (the joint descent of its 3 outputs), checked fold by fold, and one
        value+grad at N=10240 timed;
     c. at N=1024, M=10, float64, the card's DistributedGP against the CPU's
        from the same inputs: LML, gradient, posterior alpha, predictions
        and the indices of two kinds with standard errors;
     d. the north star at N=50000, M=30 on one card ('cyclic2', Npad 50176:
        one float64 (Npad, Npad) buffer written from 13 float32 strips of
        the kernel, 105 pair tiles per value+grad), at most 30
        iterations, the GSA of both kinds without errors, S1 within
        NORTH_STAR_S1_TOL of the problem's own; the float32 LML at the start
        within phase 4's bound of the float64 one; one value+grad stage by
        stage (ring gram, factor, solves, in-place inverse, pair sweep) and
        the float64 posterior, each with its time and peak memory; a strip
        of the gram as the route launches it (4096 rows against all) and the
        whole ring tile (50176^2, 30) u is v, whose output passes 2^31
        floats: its 128-row strips from the row where it does, and the last,
        against the plain version, its forward timed beside the plain one
        and its bound;
     e. the one-device streaming gradient (float32 unless named): at
        N=20000 and NORTH_STAR_UPPER_OPTIMUM, engine='upper' (the factor
        inverted in place into V, the one (Npad, Npad) buffer kept, the
        backward's pair tiles) and its 'vvt' strips against ExactLML float32
        and float64, each LML part within STREAM_F32_MULTIPLES of ExactLML
        float32's own distance from float64, the LML at the start within
        phase 4's bound, ms, the memory held after each forward and the
        peak, launches per value+grad; at N=50000, 'upper' forced (holding V
        and O(Npad 2048) after its forward) beside ExactLML, and 'cyclic'
        past GRADS_MEMORY_BUDGET_BYTES (K^-1 strips from identity-column
        solves) against 'cyclic2'; at N=24000 the float64 'cyclic' of the
        large route's rescue against float64 'cyclic2': each gradient within
        STREAM_CYCLIC_RTOL; the kernel at the new shapes, (2048^2, 30) and
        (2048 x 50176, 30), two operands, against its plain version;
  9. ROM (romcomma_tpu_torch.rom_scale, the port of benchmarks/rom_scale.py:
     N=8192, M=10, a planted plane, float32 calibrations through the kernel):
     a. the 'sobol' rotation for 3 iterations: the planted plane within 5
        degrees of rotation.csv's leading two rows, the final S[0:2] >= 0.98,
        rotation.csv orthonormal with det +1, meta.json's history; each
        stage's seconds, the S_rotated value+grad count and time, peak memory;
     b. the 'active_subspace' rotation for 2 iterations, the same angle rule,
        and predict_gradient's time per 256-point batch;
     c. at N=512, M=6, L=3, float64, the card against the CPU from identical
        inputs: predict_gradient (variant, and covariant with F
        non-diagonal), V_rotated at a random orthonormal P, the gradient of
        optimize_theta's objective in the Cayley parameters, and _cayley.
 10. the sequential loop beside the batched path: on a copy of phase 4's
     sampled repository, run.gpr and run.gsa with fold_parallel=False, their
     wall-clocks and launches printed beside phases 4 and 6's; per fold and
     output the batched descent's LML held to the sequential one's within
     phase 4's first-order bound, their iteration counts side by side; and,
     from phase 4's trained parameters, the fold-stacked GSA of phase 6 held
     to the per-fold GSA in S, V, W and T^2 within ULP_SPREADS of their
     one-ulp spreads;
 11. the CSV CLI: ``csv_script -r -a <csv> <root>`` with its defaults on a
     user CSV of OAKLEY2004 at N=4000, M=30 (K=20 folds of 3800 rows: their
     60 descents in lockstep, each round one batched launch; the improper
     fold alone; anisotropic from a cold start, maxiter 5000; then run.gsa,
     three kinds with errors, the 20 folds in one stacked pass); run.gpr and
     run.gsa seconds, rounds, launches, the rounds' value+grad and host time,
     peak memory; each fold and output's LML within phase 4's first-order
     bound, the GSA tree and every CSV finite; the stacked GSA against
     run.gsa's per-fold loop on a copy; and the likelihood layer and
     regression.gls on the card against the CPU on fold 0's test predictions;
 12. the sweep CLI: ``benchmark_script -f -r -s -M 19 --num-processes 940
     --process-id 325 <root>``, whose own selection runs the one cell of
     noise 0.1 and N=8000 (ALL, L=9, K=-2: two 4000-row folds, 18 descents
     in lockstep), its Latin hypercube drawn from SEED; the same readings and
     checks.
 13. the multi-device routes: the variant mesh engines (parallel.distributed,
     parallel.cyclic_deferred, gsa.mesh) at the north star's problem
     (N=20000, M=30, float32, at NORTH_STAR_UPPER_OPTIMUM, a recorded
     optimum of its float32 descent on engine='upper'), and the covariant
     mesh:
     a. the kernel at the mesh tiles' shapes ((20224^2, 30), the ring's one
        tile; (3584^2, 30) two operands, 'cyclic2''s pair tiles) against its
        plain version, timed, with their bounds; the one-device reference
        (engine='upper' with ExactLML: float32 and float64, the float64 posterior, the indices
        with T and their one-ulp spreads); then, in an NCCL group of this
        process alone (world size 1), DistributedGP with engine='cyclic' and
        'cyclic2' over make_n_mesh(): at the north star's start (MESH_START)
        its float32 LML within phase 4's bound of ExactLML's; at
        NORTH_STAR_UPPER_OPTIMUM its ring gram held to the one-device gram
        (VALUE_TOL), its
        float32 LML, dls, ds2 and dnoise within MESH_F32_MULTIPLES of
        ExactLML float32's own distance from float64 ExactLML, and its
        float64 ones within MESH_F64_SHARE of it; its float64 posterior alpha and predictions
        within CARD_CPU_TOL of engine='upper''s, its first-order and
        total indices (the V pass and W/T sweep over the mesh), S and T
        squared, within ULP_SPREADS of their one-ulp spreads (S itself moves
        by ~1e-6 under a one-ulp move there); value+grad and factor ms
        (median of 5) beside engine='upper''s, the value+grad's peak
        memory above what was held before it; a calibrate of 5 iterations
        from the north star's start, its unit-gram launches counted by shape;
        then, after 13c in the same group, graft_entry.dryrun_multichip(1),
        its covariant step included;
     b. where the machine has two cards or more, both engines and the
        covariant mesh on min(4, cards) spawned NCCL ranks, the engines'
        float32 LML parts within MESH_RANKS_F32_MULTIPLES (several ranks
        keep romcomma_tpu's float32 arithmetic), the covariant mesh's as in
        13c, and rank to rank bit for bit; else a line saying why it did
        not run;
     c. in 13a's group, the covariant mesh (parallel.covariant_mesh:
        DistributedCovariantGP on 'cyclic2') at phase 7's improper fold
        (N=8192, M=30, L=3: L*N = 24576 = Npad at B=256), at its trained
        gpr.c.a with F's off-diagonals set (COVARIANT_MESH_CORRELATION) and
        the lengthscales frozen, float32: its ring gram against the
        one-device covariant gram (VALUE_TOL, and whether bit for bit); its
        float32 LML, dF and dnoise within COVARIANT_MESH_F32_MULTIPLES of
        CovariantUpperLML float32's own distance from float64
        CovariantUpperLML, and its float64 ones within MESH_F64_SHARE of it;
        value+grad and factor ms (median of 5) beside CovariantUpperLML's,
        the value+grad's peak memory above what was held; a calibrate of 5
        iterations from that point, F's off-diagonals trained, its unit-gram
        launches counted by shape. The kernel at its shapes ((24576^2, 30)
        u is v, the (3584^2, 30) pair tile) is checked and timed in phases 3
        and 13a.

The last two lines of standard output are the kernels' JSON record and the
device's; the record counts the unit-gram launches of the main paths, run.gpr
of phase 4 and of phase 7, both north stars and run.gpr of phase 8, the two
ROMs of phase 9, the CLIs of phases 11 and 12 and the mesh engines' and
the covariant mesh's calibrates of phase 13, each counted from 0 just
before it runs, and the value+grads of phase 8e's streaming routes, and,
as a path of the same kernel, its batched launches among them (phases 4,
8b, 11 and 12). Exits non-zero, printing no result, where
there is no CUDA device or no checkout around the script.
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
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20241016
N, M, K, MAXITER = 8192, 30, 2, 50
#: (A, B, M, u is v). The training grams of the main path have u is v.
KERNEL_SHAPES = [(37, 61, 5, False), (4097, 4095, 30, False), (4096, 4096, 30, False),
                 (4096, 4096, 30, True), (8192, 8192, 30, True), (12288, 12288, 30, True),
                 (24576, 24576, 30, True), (20000, 20000, 30, True), (10240, 10240, 30, True),
                 (8192, 8192, 10, True)]
#: The large route's shapes (20000 and 10240 rows: ragged, masked stores) take
#: fewer timing samples than the small route's. (8192, 8192, 10) is phase 9's
#: ROM calibrations'.
TIMED_SHAPES = [(4096, 4096, 30), (8192, 8192, 30), (20000, 20000, 30), (10240, 10240, 30),
                (8192, 8192, 10)]
#: The covariant path's unit grams, (L*N)^2 over one stacked operand (u is v),
#: timed forward only, with fewer samples: a plain call at 24576^2 takes ~10 ms.
COVARIANT_TIMED_SHAPES = [(12288, 12288, 30), (24576, 24576, 30)]
#: (L, A, B, M) of the covariant gram checked through its kernel wrapper.
COVARIANT_GRAM_CASE = (3, 2048, 1536, 30)
#: (n, A, B, M, u is v) of the batched launch: the two 4096-row folds x 3
#: outputs (phase 4's fold group), phase 8b's two 5120-row folds x 3, the
#: improper fold's 3 outputs at 8192 (rbf_gram_variant in test() and
#: check_K_inv_Y), a ragged two-operand batch (masked stores, 3 M chunks),
#: and the CLIs' fold groups: csv_script's 20 folds x 3 outputs at 3800 rows
#: (phase 11) and benchmark_script's 2 folds x 9 outputs at 4000 rows, M=19
#: (phase 12).
BATCH_SHAPES = [(6, 4096, 4096, 30, True), (6, 5120, 5120, 30, True),
                (3, 8192, 8192, 30, True), (3, 4097, 1000, 70, False),
                (60, 3800, 3800, 30, True), (18, 4000, 4000, 19, True)]
#: Phase 11: csv_script's own workflow on a user CSV of OAKLEY2004 (L=3) at
#: N=4000, M=30, noise 0.04, through the CLI with its defaults: K=20 folds of
#: 3800 rows and the improper fold, anisotropic from a cold start, maxiter
#: 5000, then the three GSA kinds with errors.
CSV_N, CSV_M, CSV_K = 4000, 30, 20
CSV_ROOT = ROOT / 'build' / 'chip_smoke_csv'
#: Phase 12: benchmark_script's sweep cell 325 of the M=19 grid (20 noise
#: magnitudes x 47 N = 940 cells): noise 0.1, N=8000, the ALL vector (L=9),
#: K=-2, so two 4000-row folds and no improper fold.
SWEEP_ARGV = ['-f', '-r', '-s', '-M', '19', '--num-processes', '940', '--process-id', '325']
SWEEP_M, SWEEP_L, SWEEP_FOLDER = 19, 9, 'all.M.19.d.v.10.00.N.8000'
SWEEP_ROOT = ROOT / 'build' / 'chip_smoke_sweep'
#: A card-against-CPU check of the likelihood layer and regression.gls
#: (float64), relative to each result's largest entry: both sides factorize
#: the same well-conditioned matrices of order <= 600.
LIKELIHOOD_TOL = 1e-10
#: OAKLEY2004's inputs that its outputs depend on (the first 7 of M).
ACTIVE_INPUTS = 7
#: Phase 10's copy of phase 4's sampled repository.
SEQUENTIAL_ROOT = ROOT / 'build' / 'chip_smoke_sequential'
#: What phase 4 leaves for phase 10: its calibration records and batched launches.
MAIN_PATH = {}
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


def kernel_device_ms(torch, fn, calls=20, attempts=2):
    """Device time per call of the unit-gram kernels that fn launches, from
    torch.profiler: free of the host's launch gaps. A trace that records no
    kernel is taken again once; 0.0 if it still records none."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and any(k in e.key for k in KERNEL_NAMES))
        if ms > 0:
            return ms / calls / 1e3
    return 0.0


def share_of(bound, ms):
    """bound / ms, or 'not measured' where the profiler recorded nothing."""
    return f'{ms:.4f} ms, at {bound / ms:.3f}' if ms > 0 else 'not measured (no kernel in the trace)'


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


def forward_bound_ms(A, B, M_, shared, n=1):
    """The least time the H100 could take for one forward of n grams: each
    input read once and E written once at the HBM rate, against the kernel's
    operations at their type's peak (3xTF32 cross term 3 * 2 A B M on the
    tensor cores; about 8 float32 operations per output in the epilogue)."""
    stored = 4 * n * (A * B + (A if shared else A + B) * M_)
    operations = n * max(3 * 2 * A * B * M_ / TF32_FLOPS, 8 * A * B / F32_FLOPS)
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

        counts = ((TIMING_SAMPLES, CALLS_PER_SAMPLE) if A * B <= 8192 ** 2 else (20, 5))
        # Each version timed on its own: a plain call between kernel samples
        # leaves the L2 full of its dirty output for the kernel to write back.
        (kernel,), (plain,) = (spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, u)], *counts),
                               spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, u)], *counts))
        (kernel_fb,), (plain_fb,) = (spread_ms(torch, [fwd_bwd(gram_kernels.unit_gram)], *counts),
                                     spread_ms(torch, [fwd_bwd(gram_kernels.unit_gram_plain)], *counts))
        device = kernel_device_ms(torch, lambda: gram_kernels.unit_gram_cuda(u, u))
        bound, bound_by = forward_bound_ms(A, B, M_, shared=True)
        times[(A, B, M_)] = (kernel[1], plain[1], bound, bound_by)
        print(f'({A}, {B}, {M_}, u is v) ms per call, min / median / max of {counts[0]} '
              f'samples of {counts[1]} calls: forward kernel '
              f'{kernel[0]:.4f} / {kernel[1]:.4f} / {kernel[2]:.4f}, plain '
              f'{plain[0]:.4f} / {plain[1]:.4f} / {plain[2]:.4f}; forward+backward kernel '
              f'{kernel_fb[0]:.4f} / {kernel_fb[1]:.4f} / {kernel_fb[2]:.4f}, plain '
              f'{plain_fb[0]:.4f} / {plain_fb[1]:.4f} / {plain_fb[2]:.4f}', flush=True)
        del ug, gbar
        print(f'({A}, {B}, {M_}) forward bound {bound:.4f} ms ({bound_by}); kernel median at '
              f'{bound / kernel[1]:.3f} of it; the kernels\' device time per call (pack + gram, '
              f'torch.profiler) {share_of(bound, device)}. Backward bound '
              f'{backward_bound_ms(A, B):.4f} ms (bytes); backward alone ~'
              f'{kernel_fb[1] - kernel[1]:.4f} ms', flush=True)
    check_covariant_gram(torch, gram_kernels)
    for A, B, M_ in COVARIANT_TIMED_SHAPES:
        u, _ = unit_inputs(torch, A, B, M_, seed=7, shared=True)
        (kernel,), (plain,) = (spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, u)],
                                         samples=20, calls=5),
                               spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, u)],
                                         samples=5, calls=2))
        device = kernel_device_ms(torch, lambda: gram_kernels.unit_gram_cuda(u, u), calls=10)
        bound, bound_by = forward_bound_ms(A, B, M_, shared=True)
        times[(A, B, M_)] = (kernel[1], plain[1], bound, bound_by)
        print(f'({A}, {B}, {M_}, u is v) forward ms per call: kernel min / median / max '
              f'{kernel[0]:.4f} / {kernel[1]:.4f} / {kernel[2]:.4f} (20 samples of 5 calls), plain '
              f'{plain[0]:.4f} / {plain[1]:.4f} / {plain[2]:.4f} (5 samples of 2); bound '
              f'{bound:.4f} ms ({bound_by}), kernel median at {bound / kernel[1]:.3f} of it; '
              f'device time per call {share_of(bound, device)}', flush=True)
        del u
    u, _ = unit_inputs(torch, 128, 128, 30, seed=7, shared=True)
    print(f'wrapper host time per call at (128, 128, 30, u is v): '
          f'{host_us_per_call(torch, lambda: gram_kernels.unit_gram_cuda(u, u)):.2f} us', flush=True)
    return max_err, times


def check_covariant_gram(torch, gram_kernels):
    """The covariant gram's one launch over the stacked, differently scaled
    operands (L*A, M) and (L*B, M), F applied outside, against its plain
    version: forward, and backward in x1, x2, the lengthscales and F. F has a
    unit diagonal and entries <= 1, so VALUE_TOL holds as for E."""
    L, A, B, M_ = COVARIANT_GRAM_CASE
    g = torch.Generator().manual_seed(L * A)
    x1, x2 = ((torch.randn(n, M_, generator=g) / math.sqrt(M_)).cuda() for n in (A, B))
    ls = (0.7 + 0.6 * torch.rand(L, M_, generator=g)).cuda()
    F = (torch.full((L, L), 0.3) + 0.7 * torch.eye(L)).cuda()

    def plain(x1, x2, ls, F):
        unit = gram_kernels.unit_gram_plain(gram_kernels.stack_scaled(x1, ls),
                                            gram_kernels.stack_scaled(x2, ls))
        return F[:, None, :, None] * unit.reshape(L, A, L, B)

    gbar = torch.randn((L, A, L, B), generator=g).cuda()
    values, grads = [], []
    for fn in (gram_kernels.rbf_gram_covariant_kernel, plain):
        leaves = [t.clone().requires_grad_(True) for t in (x1, x2, ls, F)]
        value = fn(*leaves)
        values.append(value.detach())
        grads.append(torch.autograd.grad(torch.sum(value * gbar), leaves))
    err = (values[0] - values[1]).abs().max().item()
    grad_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*grads))
    print(f'covariant gram (L={L}, A={A}, B={B}, M={M_}; one ({L * A}, {L * B}) launch): forward '
          f'max |kernel - plain| = {err:.3e} (tol {VALUE_TOL}); backward in x1, x2, ls, F max '
          f'error / max |grad| = {grad_err:.3e} (tol {GRAD_RTOL})', flush=True)
    require(err <= VALUE_TOL and grad_err <= GRAD_RTOL, ('covariant gram', err, grad_err))


def check_batched(torch, gram_kernels):
    """Phase 3, the batched launch: each batch of BATCH_SHAPES against the
    plain version (VALUE_TOL) and, bit for bit, against one launch per member;
    then the batched launch, its members' single launches and the plain
    version timed (CUDA events), the device time, and the bound. Returns
    (max error, {shape: (ms, plain ms, bound ms, bound by)})."""
    max_err, times = 0.0, {}
    for n, A, B, M_, shared in BATCH_SHAPES:
        g = torch.Generator().manual_seed(n * A)
        scale = 1.5 / math.sqrt(M_)
        u = (torch.randn(n, A, M_, generator=g) * scale).cuda()
        v = u if shared else (torch.randn(n, B, M_, generator=g) * scale).cuda()
        before = (gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES)
        got = gram_kernels.unit_gram_cuda(u, v)
        torch.cuda.synchronize()
        require((gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES) ==
                (before[0] + 1, before[1] + 1), 'a batch was not one launch')
        err = (got - gram_kernels.unit_gram_plain(u, v)).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= VALUE_TOL, (n, A, B, M_, err))
        same = all(torch.equal(got[i], gram_kernels.unit_gram_cuda(u[i], v[i])) for i in range(n))
        require(same, (n, A, B, M_, 'a member differs from its own launch'))
        max_err = max(max_err, err)
        counts = (TIMING_SAMPLES, CALLS_PER_SAMPLE) if n * A * B <= 6 * 4096 ** 2 else (20, 5)

        def singles():
            for i in range(n):
                gram_kernels.unit_gram_cuda(u[i], v[i])

        (batched,), (single,), (plain,) = (
            spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, v)], *counts),
            spread_ms(torch, [singles], *counts),
            spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, v)], samples=5, calls=2))
        device = kernel_device_ms(torch, lambda: gram_kernels.unit_gram_cuda(u, v), calls=10)
        bound, bound_by = forward_bound_ms(A, B, M_, shared, n)
        times[(n, A, B, M_)] = (batched[1], plain[1], bound, bound_by)
        print(f'batch ({n}, {A}, {B}, {M_}{", u is v" if shared else ""}): max |kernel - plain| '
              f'{err:.3e} (tol {VALUE_TOL}), each member bit for bit its own launch; ms, min / '
              f'median / max of {counts[0]} samples of {counts[1]} calls: one batched launch '
              f'{batched[0]:.4f} / {batched[1]:.4f} / {batched[2]:.4f}, {n} single launches '
              f'{single[0]:.4f} / {single[1]:.4f} / {single[2]:.4f}, plain (5 samples of 2) '
              f'{plain[1]:.4f}; bound {bound:.4f} ms ({bound_by}), batched median at '
              f'{bound / batched[1]:.3f} of it, singles at {bound / single[1]:.3f}; device time '
              f'per batched call {share_of(bound, device)}', flush=True)
        del u, v, got
    return max_err, times


def main_path(torch, user, gram_kernels):
    """Phase 4: sample -> k-fold -> run.gpr at full size, through the kernel."""
    root = ROOT / 'build' / 'chip_smoke'
    shutil.rmtree(root, ignore_errors=True)
    np_seed(SEED)
    noise = user.sample.GaussianNoise.Variance(L=len(user.functions.OAKLEY2004), magnitude=0.04)
    repo = user.sample.Function(root, user.sample.DOE.latin_hypercube, user.functions.OAKLEY2004,
                                N=N, M=M, noise_variance=noise, overwrite_existing=True,
                                seed=SEED).repo.into_K_folds(K)
    shutil.rmtree(SEQUENTIAL_ROOT, ignore_errors=True)
    shutil.copytree(repo.folder, SEQUENTIAL_ROOT)             # phase 10's sampled copy
    gram_kernels.LAUNCHES = gram_kernels.BATCHED_LAUNCHES = 0
    with calibration_records(torch, gram_kernels) as records:
        t0 = time.perf_counter()
        names = user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=None,
                             maxiter=MAXITER, fold_parallel=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches, batched = gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES
    print(f'run.gpr: {seconds:.2f} s, models {names}, folds {list(repo.folds)}, '
          f'unit-gram kernel launches {launches}, of them batched {batched}', flush=True)
    print_calibration_records(records)
    require(launches > 0, 'the main path never launched the unit-gram kernel')
    require(batched > 0 and any(r['step'] == 'fold-batched' and r['size'] == K * 3
                                for r in records),
            'the main path never ran a fold group through the batched launch')
    MAIN_PATH.update(records=records, batched_launches=batched)
    require(names == ['gpr.v.i', 'gpr.v.a'], names)
    worst = check_lml_bounds(torch, repo, names)
    summary = repo.folder / 'gpr.v.a' / 'test_summary.csv'
    print(f'test_summary (anisotropic, all folds):\n{summary.read_text()}', flush=True)
    return repo, launches, seconds, worst


def check_lml_bounds(torch, repo, names, echo=True):
    """Each fold and model of a repository trained in float32: test.csv and
    test_summary.csv written, and each output's float32 LML (through the
    kernel) within the first-order bound of the float64 plain LML from the
    same parameters. Returns the worst error / bound."""
    from romcomma_tpu_torch.models import gp, params
    from romcomma_tpu_torch.models.gpr import MOGP
    from romcomma_tpu_torch.data.storage import Fold
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
            ratio = error / bound
            l = int(ratio.argmax())
            if ratio[l].item() >= worst:
                worst = ratio[l].item()
                where = (f'fold.{k} {name} output {l}: LML {lml64[l].item():.6f}, |diff| '
                         f'{error[l].item():.3e}, bound {bound[l].item():.3e}; variance '
                         f'{c["variance"][l].item():.4g}, noise {c["noise"][l].item():.4g}, '
                         f'lengthscales {c["lengthscales"][l].min().item():.4g} to '
                         f'{c["lengthscales"][l].max().item():.4g}')
            if echo:
                print(f'fold.{k} {name} N={model.N}: LML f32 kernel {lml32.tolist()} vs f64 plain '
                      f'{lml64.tolist()}; |diff| {error.tolist()} bound {bound.tolist()}; {stored}',
                      flush=True)
            require(bool((error <= bound).all()), (k, name, error, bound))
    if not echo:
        print(f'  the closest to its bound: {where}', flush=True)
    return worst


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


GSA_OPTIONS = dict(is_covariant=False, is_isotropic=False, is_error_calculated=True,
                   is_T_partial=False)
KINDS = ('first_order', 'closed', 'total')


@contextmanager
def gsa_records(torch, keep_inputs=False):
    """Record, for each fold that run.gsa computes, its GSA wall-clock
    (posterior factors, calibrator set-up and every slice of every kind), the
    spans of its V pass and W/T sweep (base.tracing, on for the body), and
    its results on the host, and with keep_inputs its float64 inputs (F,
    K_cho, K_inv_Y, Lambda, X) too, and K^-1 y among its results. The folds
    of a fold group, which run.gsa's batched path computes in one stacked
    pass, carry the group's size, wall-clock and spans. run.gsa is left as
    it is; the record wraps the functions it reaches
    (run.marginalize_all_kinds, one fold, and run.marginalize_all_kinds_folds,
    a group, and under both calibrators.marginalize_intervals_folds), and
    restores them and the tracing mode on exit."""
    from romcomma_tpu_torch.base import tracing
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.user import run
    records = []
    marginalize, folds = run.marginalize_all_kinds, run.marginalize_all_kinds_folds
    intervals = calibrators.marginalize_intervals_folds

    def timed_intervals(cals, slices):
        before = len(tracing.spans())
        out = intervals(cals, slices)
        stages = {s['name']: s for s in tracing.spans()[before:]}
        for cal in cals:
            records.append({'N': cal.N, 'V0_chunk': cal._auto_n_chunk(), 'group': len(cals),
                            'stages': stages})
        return out

    def keep(record, gp, by_kind, extras, seconds):
        record['seconds'] = seconds
        record['results'] = ({kind: {k: v.cpu().numpy() for k, v in out.items()}
                              for kind, out in by_kind.items()},
                             {k: v.cpu().numpy() for k, v in extras.items()})
        if keep_inputs:      # gp's posterior factors are cached: no second Cholesky
            record['inputs'] = {k: v.cpu() for k, v in
                                calibrators.ClosedSobol.gather_arrays(gp).items()}
            record['shape'] = {'L': gp.L, 'M': gp.M, 'N': gp.N}
            record['results'][1]['K_inv_Y'] = record['inputs']['K_inv_Y'].numpy()

    def timed(function, gps, *args, **kwargs):
        """function(gps, ...), one (by_kind, extras) per gp, each kept in the
        record its calibrator made."""
        t0 = time.perf_counter()
        outs = function(gps, *args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for record, gp, (by_kind, extras) in zip(records[-len(gps):], gps, outs):
            keep(record, gp, by_kind, extras, seconds)
        return outs

    run.marginalize_all_kinds = lambda gp, *a, **k: timed(
        lambda gps, *a_, **k_: [marginalize(gps[0], *a_, **k_)], [gp], *a, **k)[0]
    run.marginalize_all_kinds_folds = lambda gps, *a, **k: timed(folds, gps, *a, **k)
    calibrators.marginalize_intervals_folds = timed_intervals
    mode = tracing.mode('on')
    try:
        yield records
    finally:
        tracing.mode(mode)
        run.marginalize_all_kinds, run.marginalize_all_kinds_folds = marginalize, folds
        calibrators.marginalize_intervals_folds = intervals


def check_gsa_tree(repo, model='gpr.v.a', csvs='SVTW', M_=M, L_=3):
    """Every fold's `csvs` of every kind exist and are finite, with L_^2 rows
    and one column per m (and the full slice's m=M_ in S, V and T); the full
    slice's S has a unit diagonal; CLOSED S (each output's own index, the
    diagonal) does not decrease in m; T >= 0."""
    import numpy as np
    import pandas as pd
    for k in repo.folds:
        for kind in KINDS:
            folder = repo.fold_folder(k) / model / 'gsa' / kind
            frames = {csv: pd.read_csv(folder / f'{csv}.csv', index_col=[0, 1]) for csv in csvs}
            for csv, frame in frames.items():
                columns = M_ if csv == 'W' else M_ + 1
                require(frame.shape == (L_ * L_, columns)
                        and bool(np.isfinite(frame.to_numpy()).all()),
                        f'{folder / csv}.csv: shape {frame.shape}, or not finite')
            S = frames['S']
            diagonal = [(l, l) for l in range(L_)]
            require(np.abs(S.loc[diagonal, str(M_)].to_numpy() - 1).max() <= 1e-9,
                    f'{folder}: the full slice\'s S has no unit diagonal')
            require('T' not in frames or bool((frames['T'].to_numpy() >= 0).all()),
                    f'{folder}: T < 0')
            if kind == 'closed':
                steps = np.diff(S.loc[diagonal].to_numpy(), axis=1)
                require(steps.min() >= -1e-6, f'{folder}: CLOSED S decreases by {steps.min()}')


def _stage_s(stage):
    """A span's seconds: its device time on a card, its host time elsewhere."""
    ms = stage['host_ms'] if stage['device_ms'] is None else stage['device_ms']
    return ms / 1e3


def print_gsa_records(records):
    """One line per fold, or per fold group (its folds share the line)."""
    i = 0
    while i < len(records):
        r = records[i]
        v_pass, wt_sweep = r['stages']['gsa.v_pass'], r['stages']['gsa.wt_sweep']
        chunk = r['V0_chunk'] or 'N'
        who = f'fold group of {r["group"]} folds' if r['group'] > 1 else 'one fold'
        print(f'  N={r["N"]}, {who}: GSA {r["seconds"]:.3f} s (posterior factors, set-up with '
              f'the full V in chunks of {chunk}, intervals); V pass {_stage_s(v_pass):.3f} s '
              f'({v_pass["attrs"]["chunks"]} chunks); W/T sweep {_stage_s(wt_sweep):.3f} s',
              flush=True)
        i += r['group']


def gsa_main_path(torch, user, gram_kernels, repo):
    """Phase 6, the full-size run: run.gsa on phase 4's repository, checked,
    timed, its peak memory read, and one N=4096 fold profiled."""
    from torch.autograd import DeviceType
    from romcomma_tpu_torch.data.storage import Fold
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gram_kernels.LAUNCHES = 0
    with gsa_records(torch) as records:
        t0 = time.perf_counter()
        names = user.run.gsa('gpr', repo, kinds=user.run.GSA.ALL_KINDS, fold_parallel=True,
                             **GSA_OPTIONS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'run.gsa: {seconds:.2f} s for folds {list(repo.folds)}, names {[str(n) for n in names]}; '
          f'peak device memory {peak:.2f} GiB; unit-gram kernel launches {gram_kernels.LAUNCHES} '
          f'(the GSA runs in float64 and has no kernel of its own)', flush=True)
    print_gsa_records(records)
    require(len(records) == len(repo.folds) and all('results' in r for r in records), records)
    require([r['group'] for r in records] == [K, K, 1],
            f'the {K} equal folds did not run as one fold group: {[r["group"] for r in records]}')
    check_gsa_tree(repo)
    MAIN_PATH.update(gsa_records=records, gsa_seconds=seconds)
    fold = Fold(repo, 0)
    t0 = time.perf_counter()
    user.run.gsa('gpr', fold, kinds=user.run.GSA.ALL_KINDS, **GSA_OPTIONS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # Device activity only: host events of ~50 000 launches take a minute to
    # aggregate. The idle share is read from the profiled run alone.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        user.run.gsa('gpr', fold, kinds=user.run.GSA.ALL_KINDS, **GSA_OPTIONS)
        torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f'profile of run.gsa on fold 0 (N={fold.N}): {profiled:.1f} ms wall under the '
          f'profiler ({wall:.1f} ms in a run without it); device busy {busy:.1f} ms, idle share '
          f'{1 - busy / profiled:.3f} of the profiled wall; {sum(e.count for e in kernels)} '
          'kernel launches; top kernels by device time:', flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:230]}',
              flush=True)
    profile_stacked_gsa(torch, repo)


def profile_stacked_gsa(torch, repo):
    """Phase 6: the stacked pass of the two 4096-row folds
    (marginalize_all_kinds_folds) beside one fold's (marginalize_all_kinds),
    each timed once and profiled once (device activity): wall-clock, device
    busy time, idle share and kernel launches."""
    from torch.autograd import DeviceType
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.gsa.models import GSA, Sobol
    from romcomma_tpu_torch.models.gpr import MOGP
    gps = [MOGP('gpr.v.a', Fold(repo, k), is_read=True, is_covariant=False, is_isotropic=False)
           for k in range(K)]
    sobols = [Sobol(gps[0], kind, -1, True, is_T_partial=False) for kind in GSA.ALL_KINDS]
    kind_slices = {s.kind.name: tuple(s._m_dataset) for s in sobols}
    runs = {f'stacked pass of folds 0..{K - 1}': lambda: calibrators.marginalize_all_kinds_folds(
                gps, kind_slices, True, **sobols[0].meta),
            'fold 0 alone': lambda: calibrators.marginalize_all_kinds(
                gps[0], kind_slices, True, **sobols[0].meta)}
    for gp in gps:
        gp.posterior_factors                   # cached: no Cholesky in what is timed
    readings = {}
    for label, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            profiled = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        launches = sum(e.count for e in kernels)
        readings[label] = (wall, launches)
        print(f'{label} (N={gps[0].N}, all kinds, errors): {wall:.3f} s; profiled {profiled:.3f} s, '
              f'device busy {busy:.3f} s, idle share {1 - busy / profiled:.3f}, {launches} kernel '
              f'launches', flush=True)
    MAIN_PATH['stacked_gsa'] = readings


#: The card's GSA is held to the CPU's within this many times the spread
#: that a one-ulp perturbation causes on the CPU, on the same posterior. W =
#: mu_phi_mu - mu_psi_mu is a difference of quadforms grown by cond(K), and
#: T^2 = |Q| / V4 one more, so how far two correct float64 evaluations land
#: apart depends on the posterior: 1e-8 to 2e-5 of W's largest entry on
#: installation-test posteriors. This script prints, for each posterior,
#: each table's distance in units of its spread (PERF.md records the
#: readings); romcomma_tpu and the port on the CPU stay within 10 spreads
#: too (tests/test_torch_gsa.py, the ill-conditioned case).
ULP_SPREADS = 10
#: The spread is the largest response over this many random one-ulp draws.
ULP_DRAWS = 3
#: The chunk size that runs every chunk loop of the GSA several times at the
#: installation test's N = 150 and 300.
SMALL_CHUNK = 16
#: The GSA's slices in one pass over every kind, as run.gsa makes them.
SLICE_KINDS = {'FIRST_ORDER': lambda m, M_: (m, m + 1), 'CLOSED': lambda m, M_: (0, m + 1),
               'TOTAL': lambda m, M_: (m + 1, M_)}


def _table_errors(results, reference):
    """The worst |results - reference| of each table (one kind's S, V, W or
    T^2, an extra, or K^-1 y where both hold it), relative to the table's
    largest |reference| entry, by key (T is compared squared: its square
    root amplifies entries that cancel to 0)."""
    import numpy as np
    (kinds, extras), (ref_kinds, ref_extras) = results, reference
    pairs = [(key, kinds[kind][key], ref_kinds[kind][key]) for kind in kinds for key in 'SVWT']
    pairs += [(key[0], extras[key], ref_extras[key]) for key in ('S', 'V0', 'T')]
    if 'K_inv_Y' in extras and 'K_inv_Y' in ref_extras:
        pairs.append(('K^-1 y', extras['K_inv_Y'], ref_extras['K_inv_Y']))
    worst = {}
    for key, got, want in pairs:
        require(bool(np.isfinite(got).all()), f'{key} is not finite')
        if key == 'T':
            got, want = got * got, want * want
        error = float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)
        worst[key] = max(worst.get(key, 0.0), error)
    return worst


def gsa_of(inputs, shape, **meta):
    """(results, extras) of one pass over every kind's slices on the current
    device, from float64 inputs, on the host, with K^-1 y among the extras;
    and the chunk counts of its V pass and W/T sweep, by the program's own
    rules."""
    from romcomma_tpu_torch.gsa import calibrators, factorized_errors
    M_ = shape['M']
    slices = tuple(slice_of(m, M_) for slice_of in SLICE_KINDS.values() for m in range(M_))
    cal = calibrators.ClosedSobolWithError.from_arrays(**inputs, is_F_diagonal=True, **shape,
                                                       is_T_partial=False, **meta)
    out = cal.marginalize_intervals(slices)
    return ({kind: {key: v[..., i * M_:(i + 1) * M_].cpu().numpy() for key, v in out.items()}
             for i, kind in enumerate(SLICE_KINDS)},
            {'V0': cal.V[0].cpu().numpy(), 'S': cal.S.cpu().numpy(), 'T': cal.T.cpu().numpy(),
             'K_inv_Y': inputs['K_inv_Y'].cpu().numpy()}), {
        'v_chunks': -(-cal.N // cal._intervals_chunk()),
        'e_chunks': -(-cal.N // factorized_errors._chunk_size(
            cal, len(factorized_errors._member_layout(cal))))}


def _signs(torch, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.where(torch.rand(shape, generator=g) < 0.5, -1.0, 1.0).double()


def refactored(torch, inputs, seed=None):
    """inputs with K rebuilt from K_cho, moved by one ulp in random symmetric
    directions when a seed is given, and factored afresh: K_cho and K^-1 y
    of the same y, as another float64 implementation would make them."""
    K_cho, K_inv_Y = inputs['K_cho'], inputs['K_inv_Y']
    K = K_cho @ K_cho.mT
    y = K @ K_inv_Y.mT
    if seed is not None:
        signs = torch.triu(_signs(torch, K.shape, seed))
        K = K * (1 + 2.0 ** -52 * (signs + torch.triu(signs, 1).mT))
    chol = torch.linalg.cholesky(K)
    return inputs | {'K_cho': chol, 'K_inv_Y': torch.cholesky_solve(y, chol).mT}


def ulp_moved(torch, raw, seed):
    """raw parameters, each moved by one ulp of its dtype in a random
    direction."""
    g = torch.Generator().manual_seed(seed)
    return {name: torch.nextafter(t, torch.where(torch.rand(t.shape, generator=g) < 0.5,
                                                 -math.inf, math.inf).to(t.dtype))
            for name, t in raw.items()}


def ulps_apart(torch, a, b):
    """How many entries of two raw-parameter sets differ, and by at most how
    many ulps."""
    moved = [(x.view(torch.int32) - y.view(torch.int32)).abs() if x.dtype == torch.float32
             else (x != y).int() for x, y in ((a[k], b[k]) for k in a)]
    return sum(int((m > 0).sum()) for m in moved), max(int(m.max()) for m in moved)


def spread(base, nudged):
    """Each table's largest response, over ULP_DRAWS draws, to the one-ulp
    perturbation nudged(draw), from base."""
    worst = {}
    for draw in range(ULP_DRAWS):
        for key, e in _table_errors(nudged(draw), base).items():
            worst[key] = max(worst.get(key, 0.0), e)
    return worst


def within_spreads(label, apart, ulps, readings):
    """Print each table's distance against its spread; record the ratios."""
    print(f'  {label}: worst |a - b| / max |b| (T squared) against the spread: ' + ', '.join(
        f'{key} {apart[key]:.2e} / {ulps[key]:.2e}' for key in apart), flush=True)
    readings.extend(apart[key] / ulps[key] if ulps[key] else (math.inf if apart[key] else 0.0)
                    for key in apart)


def gsa_card_against_cpu(torch, user):
    """Phase 6, the reference checks, on the port's installation test (run
    on the card; 3 folds, N = 150, 150, 300, M=7, L=3). Each table is held
    within ULP_SPREADS of its spread on the CPU, from the same posterior:
    1. the card's GSA against the CPU's from the card's own float64 inputs,
       so that only the arithmetic differs; spread: one ulp of K^-1 y;
    2. the card's chunk loops (n_chunk=SMALL_CHUNK, so the set-up V, the V
       pass and the W/T sweep each run in several chunks, as at full size)
       against its one-chunk path on the same inputs; spread as in 1;
    3. end to end, with K^-1 y: run.gsa on a copy of the trained tree pinned
       to the CPU. The parameters enter the float64 posterior through the
       float32 working dtype, whose transcendentals may round differently
       on each device; spread: one float32 ulp of every raw parameter;
    4. the card's posterior factors and GSA against the CPU's from the
       card's own float32 parameters, so that only the float64 gram,
       Cholesky and GSA differ; spread: one ulp of K, factored afresh."""
    from romcomma_tpu_torch import installation_test
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.models import gp as gp_module
    from romcomma_tpu_torch.models.gpr import MOGP
    root = ROOT / 'build' / 'chip_smoke_installation'
    shutil.rmtree(root, ignore_errors=True)
    np_seed(SEED)
    t0 = time.perf_counter()
    with gsa_records(torch, keep_inputs=True) as card:
        (folder,) = installation_test.run(root / 'card')
    print(f'installation test on the card: {time.perf_counter() - t0:.2f} s', flush=True)
    print_gsa_records(card)
    shutil.copytree(folder, root / 'cpu' / folder.name)
    repo = Repository(root / 'cpu' / folder.name)
    with user.contexts.Environment('GSA on the CPU', device='CPU'), \
            gsa_records(torch, keep_inputs=True) as cpu:
        user.run.gsa('gpr', repo, kinds=user.run.GSA.ALL_KINDS, **GSA_OPTIONS)
    require(len(card) == len(cpu) == len(repo.folds), (len(card), len(cpu)))

    def model(repository, k):
        return MOGP('gpr.v.a', Fold(repository, k), is_read=True, is_covariant=False,
                    is_isotropic=False)

    readings = {check: [] for check in ('same inputs', 'chunks', 'end to end',
                                        'from the card\'s parameters')}
    for k, (on_card, on_cpu) in enumerate(zip(card, cpu)):
        shape, inputs, cpu_in = on_card['shape'], on_card['inputs'], on_cpu['inputs']
        card_raw = {name: t.cpu() for name, t in model(Repository(folder), k)._variant_raw().items()}
        print(f'fold {k} N={on_card["N"]}:', flush=True)
        with user.contexts.Environment('GSA on the CPU from the card\'s inputs', device='CPU'):
            base, _ = gsa_of(inputs, shape)
            ulps = spread(base, lambda d: gsa_of(inputs | {'K_inv_Y': inputs['K_inv_Y'] * (
                1 + 2.0 ** -52 * _signs(torch, inputs['K_inv_Y'].shape, 100 * k + d))}, shape)[0])
            if k == 0:
                first_ulps = ulps
            gp = model(repo, k)
            raw, X, Y = gp._variant_raw(), gp._tensor(gp.X), gp._tensor(gp.Y)

            def posterior(raw_):
                K_cho, K_inv_Y = gp_module.posterior_factors_variant(raw_, X, Y)
                return cpu_in | {'K_cho': K_cho, 'K_inv_Y': K_inv_Y}

            raw_ulps = spread(gsa_of(posterior(raw), shape)[0],
                              lambda d: gsa_of(posterior(ulp_moved(torch, raw, 100 * k + d)),
                                               shape)[0])
            from_card = posterior(card_raw)
            from_card_gsa, _ = gsa_of(from_card, shape)
            K_ulps = spread(gsa_of(refactored(torch, from_card), shape)[0],
                            lambda d: gsa_of(refactored(torch, from_card, 100 * k + d), shape)[0])
        within_spreads('1. card against the CPU, same inputs',
                       _table_errors(on_card['results'], base), ulps, readings['same inputs'])
        whole, whole_t = gsa_of(inputs, shape, n_chunk=0)
        chunked, chunked_t = gsa_of(inputs, shape, n_chunk=SMALL_CHUNK)
        require(whole_t['v_chunks'] == whole_t['e_chunks'] == 1
                and min(chunked_t['v_chunks'], chunked_t['e_chunks']) > 1, (whole_t, chunked_t))
        within_spreads(f'2. the card in chunks of {SMALL_CHUNK} ({chunked_t["v_chunks"]} V, '
                       f'{chunked_t["e_chunks"]} W/T) against one chunk',
                       _table_errors(chunked, whole), ulps, readings['chunks'])
        moved, most = ulps_apart(torch, card_raw, raw)
        within_spreads(f'3. card against the CPU end to end ({moved} raw parameters apart, by '
                       f'at most {most} ulps), one-float32-ulp-of-the-parameters spread',
                       _table_errors(on_card['results'], on_cpu['results']), raw_ulps,
                       readings['end to end'])
        within_spreads('4. card against the CPU from the card\'s parameters, one-ulp-of-K '
                       'spread', _table_errors(on_card['results'], from_card_gsa), K_ulps,
                       readings['from the card\'s parameters'])
    for check, ratios in readings.items():
        print(f'{check}: largest distance {max(ratios):.3f} spreads (limit {ULP_SPREADS})',
              flush=True)
    require(all(max(ratios) <= ULP_SPREADS for ratios in readings.values()),
            'the card and the CPU, or the card\'s chunked and one-chunk paths, computed '
            'different posterior factors or indices')
    sweep_against_per_slice(card[0], first_ulps)


def sweep_against_per_slice(record, ulps):
    """Phase 6: on the card, the factorized W/T sweep of one installation-size
    fold against the card's own per-slice path (ClosedSobolWithError.
    marginalize), every slice of every kind, held within ULP_SPREADS of
    ``ulps``, the fold's one-ulp-of-K^-1 y spread (check 1). The distances
    beside tests/test_gsa_chunked.py's tolerances (rtol 1e-9; atol 1e-11, T
    1e-7) are printed too: those suit its well-conditioned N=60 posterior,
    and this one's W moves by ~2e-7 of its largest entry for one ulp of
    K^-1 y."""
    import numpy as np
    from romcomma_tpu_torch.gsa import calibrators
    shape, M_ = record['shape'], record['shape']['M']
    t0 = time.perf_counter()
    swept, _ = gsa_of(record['inputs'], shape)
    sweep_s = time.perf_counter() - t0
    cal = calibrators.ClosedSobolWithError.from_arrays(**record['inputs'], is_F_diagonal=True,
                                                       **shape, is_T_partial=False)
    t0 = time.perf_counter()
    per_slice = {}
    for kind, slice_of in SLICE_KINDS.items():
        outs = [cal.marginalize(slice_of(m, M_)) for m in range(M_)]
        per_slice[kind] = {key: np.stack([out[key].cpu().numpy() for out in outs], axis=-1)
                           for key in 'SVWT'}
    per_slice_s = time.perf_counter() - t0
    excess = {key: max(float((np.abs(swept[0][kind][key] - per_slice[kind][key])
                              - (1e-7 if key == 'T' else 1e-11)
                              - 1e-9 * np.abs(per_slice[kind][key])).max())
                       for kind in SLICE_KINDS) for key in 'SVWT'}
    readings = []
    within_spreads(f'the card\'s W/T sweep ({sweep_s:.3f} s) against its per-slice path '
                   f'({per_slice_s:.3f} s), N={shape["N"]}, {len(SLICE_KINDS) * M_} slices',
                   _table_errors(swept, (per_slice, swept[1])), ulps, readings)
    print(f'  largest distance {max(readings):.3f} spreads (limit {ULP_SPREADS}); beside '
          f'tests/test_gsa_chunked.py\'s tolerances, the worst excess by table: {excess}',
          flush=True)
    require(max(readings) <= ULP_SPREADS, ('sweep against per-slice', readings))


#: The device that phase 7 measures and checks against the CPU.
CARD = 'cuda'
#: The covariant pass of run.gpr, as a user runs it after the variant passes.
COVARIANT_OPTIONS = dict(is_covariant=True, is_isotropic=False)
#: The card's float64 LML, gradient, predictions and GSA against the CPU's,
#: from the same float64 inputs, relative to each table's largest entry: two
#: float64 Choleskys of one matrix of cond(K) ~ 1e4 differ by ~cond(K) eps64
#: ~ 1e-12, and phase 6's card-against-CPU S and V agree to ~2e-10 (PERF.md).
CARD_CPU_TOL = 1e-8
#: The installation test's size (romcomma_tpu_torch/installation_test.py).
INSTALLATION_N, INSTALLATION_M = 300, 7


@contextmanager
def calibration_records(torch, gram_kernels):
    """Record every MOGP.calibrate and MOGP.test that run.gpr makes: its
    fold, model, seconds (the card synchronised at both ends) and unit-gram
    launches; and every fold group that run.gpr's batched path calibrates
    (gp.calibrate_variant_folds), as one 'fold-batched' record of its
    descents (size, seconds, launches, batched launches, each descent's
    iterations and scipy stop) and, for each fold it writes back
    (MOGP._finish_variant_calibration outside MOGP.calibrate), a 'calibrate'
    record carrying the group's seconds and launches. run.gpr is left as it
    is; the functions are restored on exit."""
    from romcomma_tpu_torch.models import gp
    from romcomma_tpu_torch.models.gpr import MOGP
    records = []
    state = {'in_calibrate': 0, 'group': None}
    originals = {'calibrate': MOGP.calibrate, 'test': MOGP.test}
    finish, folds = MOGP._finish_variant_calibration, gp.calibrate_variant_folds

    def recorded(step, method):
        def wrapper(self, *args, **kwargs):
            torch.cuda.synchronize()
            launches, t0 = gram_kernels.LAUNCHES, time.perf_counter()
            state['in_calibrate'] += step == 'calibrate'
            try:
                out = method(self, *args, **kwargs)
            finally:
                state['in_calibrate'] -= step == 'calibrate'
            torch.cuda.synchronize()
            records.append({'k': self.fold.meta['k'], 'name': self.folder.name, 'step': step,
                            'seconds': time.perf_counter() - t0,
                            'launches': gram_kernels.LAUNCHES - launches})
            return out
        return wrapper

    def recorded_folds(raws, *args, **kwargs):
        torch.cuda.synchronize()
        launches, batched = gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES
        t0 = time.perf_counter()
        out = folds(raws, *args, **kwargs)
        torch.cuda.synchronize()
        K_, L_ = out[1].shape
        state['group'] = {'k': None, 'step': 'fold-batched', 'size': K_ * L_, 'folds': K_,
                          'seconds': time.perf_counter() - t0,
                          'launches': gram_kernels.LAUNCHES - launches,
                          'batched': gram_kernels.BATCHED_LAUNCHES - batched,
                          'iterations': out[2].tolist(), 'stops': out[3], 'written': 0}
        records.append(state['group'])
        return out

    def recorded_finish(self, *args, **kwargs):
        out = finish(self, *args, **kwargs)
        group = state['group']
        if not state['in_calibrate'] and group is not None:
            j = group['written']
            group['written'] += 1
            records.append({'k': self.fold.meta['k'], 'name': self.folder.name,
                            'step': 'calibrate', 'seconds': group['seconds'],
                            'launches': group['launches'], 'group': group['folds'],
                            'iterations': group['iterations'][j], 'stops': group['stops'][j]})
        return out

    for step, method in originals.items():
        setattr(MOGP, step, recorded(step, method))
    MOGP._finish_variant_calibration, gp.calibrate_variant_folds = recorded_finish, recorded_folds
    try:
        yield records
    finally:
        for step, method in originals.items():
            setattr(MOGP, step, method)
        MOGP._finish_variant_calibration, gp.calibrate_variant_folds = finish, folds


def print_calibration_records(records):
    """Each fold group's descents, then each fold's calibrate and test."""
    for r in records:
        if r['step'] == 'fold-batched':
            print(f'  fold group of {r["folds"]} folds, {r["size"]} descents in lockstep: '
                  f'{r["seconds"]:.2f} s, {r["launches"]} unit-gram launches ({r["batched"]} '
                  f'batched); iterations {r["iterations"]}; scipy stops {r["stops"]}', flush=True)
        else:
            group = f' (in a fold group of {r["group"]})' if 'group' in r else ''
            print(f'  fold.{r["k"]} {r["name"]} {r["step"]}{group}: {r["seconds"]:.2f} s, '
                  f'{r["launches"]} launches', flush=True)


def trained_covariant(torch, folder, on, dtype):
    """The raw covariant parameters stored under a trained model's folder,
    read from its CSVs (no reload, which would diagonalize the noise
    covariance), made at FLOAT() on `on` and cast to `dtype`; and the
    constrained F and noise covariance."""
    from romcomma_tpu_torch.base.classes import Frame
    from romcomma_tpu_torch.models import params
    F, ls, noise = (Frame(folder / csv).np for csv in ('kernel/variance', 'kernel/lengthscales',
                                                        'likelihood/variance'))
    raw = {n: t.to(dtype) for n, t in params.covariant_init(F, ls, noise, on=on).items()}
    return raw, F, ls, noise


def fold_tensors(torch, fold, dtype, on=None):
    return tuple(torch.tensor(frame.to_numpy(dtype=float), dtype=dtype, device=on or CARD)
                 for frame in (fold.X, fold.Y))


def covariant_main_path(torch, user, gram_kernels, repo):
    """Phase 7, the full-size run: run.gpr's covariant pass on phase 4's
    repository, lengthscales frozen (CovariantUpperLML), checked fold by
    fold."""
    import numpy as np
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models import gp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gram_kernels.LAUNCHES = 0
    with calibration_records(torch, gram_kernels) as records:
        t0 = time.perf_counter()
        names = user.run.gpr('gpr', repo, is_read=None, maxiter=MAXITER, **COVARIANT_OPTIONS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = gram_kernels.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'run.gpr covariant: {seconds:.2f} s, models {names}, folds {list(repo.folds)}, '
          f'unit-gram kernel launches {launches}, peak device memory {peak:.2f} GiB', flush=True)
    require(names == ['gpr.c.a'], names)
    worst = 0.0
    for k in repo.folds:
        fold = Fold(repo, k)
        folder = fold.folder / 'gpr.c.a'
        mine = {r['step']: r for r in records if r['k'] == k}
        require(set(mine) == {'calibrate', 'test'} and mine['calibrate']['launches'] > 0,
                f'fold {k}: no covariant calibration through the unit-gram kernel: {mine}')
        require((folder / 'test.csv').is_file() and (folder / 'test_summary.csv').is_file(),
                f'{folder} has no test.csv or test_summary.csv')
        result = json.loads((folder / 'meta.json').read_text())['result']
        raw, F, _, noise = trained_covariant(torch, folder, CARD, torch.float32)
        X, Y = fold_tensors(torch, fold, torch.float32)
        with torch.no_grad():
            lml32 = gp.lml_covariant(raw, X, Y).item()
            lml64 = gp.lml_covariant({n: t.double() for n, t in raw.items()}, X.double(),
                                     Y.double()).item()
        # The first-order bound of phase 4 with L*N rows: the float32 gram and
        # Cholesky perturb K by ~eps32 * s2 per entry, which moves log|K| and
        # y'K^-1 y by up to ~LN eps32 s2 / noise; 10x that is the bound.
        LN = X.shape[0] * Y.shape[1]
        bound = 10 * LN * 1.1920929e-07 * (np.diag(F).max() / np.diag(noise).min() + 1.0)
        worst = max(worst, abs(lml32 - lml64) / bound)
        print(f'fold.{k} gpr.c.a L*N={LN}: calibrate {mine["calibrate"]["seconds"]:.2f} s '
              f'({mine["calibrate"]["launches"]} launches), test {mine["test"]["seconds"]:.2f} s; '
              f'{result}; LML f32 kernel {lml32:.6f} vs f64 plain {lml64:.6f}, |diff| '
              f'{abs(lml32 - lml64):.3e} bound {bound:.3e}; F diagonal {np.diag(F).tolist()}, '
              f'noise diagonal {np.diag(noise).tolist()}', flush=True)
        require(math.isfinite(lml32) and math.isfinite(lml64) and abs(lml32 - lml64) <= bound,
                (k, lml32, lml64, bound))
    return launches, seconds, worst


def profile_covariant(torch, gram_kernels, repo):
    """Phase 7: one lengthscale-frozen value+grad (CovariantUpperLML) at L*N = 12288
    and 24576, and one lengthscale-trainable value+grad (the autograd
    objective, which runs the unit gram's forward and backward every
    evaluation) at 12288, at the trained parameters, in float32."""
    from torch.autograd import DeviceType
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models import gp, params
    for k, route in ((0, 'lengthscales frozen'), (2, 'lengthscales frozen'),
                     (0, 'lengthscales trainable')):
        fold = Fold(repo, k)
        raw, _, _, _ = trained_covariant(torch, fold.folder / 'gpr.c.a', CARD, torch.float32)
        X, Y = fold_tensors(torch, fold, torch.float32)
        mask = params.covariant_mask(lengthscales=route == 'lengthscales trainable')
        objective, _ = gp._covariant_objective(raw, mask, X, Y)

        def step():
            p = {name: t.clone().requires_grad_(True) for name, t in raw.items()}
            torch.autograd.grad(objective(p), list(p.values()), allow_unused=True)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches, t0 = gram_kernels.LAUNCHES, time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        per_step = (gram_kernels.LAUNCHES - launches) / 3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            profiled = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        gram_ms = sum(e.self_device_time_total for e in kernels
                      if any(n in e.key for n in KERNEL_NAMES)) / 1e3
        print(f'{route}, L*N={X.shape[0] * Y.shape[1]}: one value+grad {wall:.2f} ms wall (mean of '
              f'3); profiled {profiled:.2f} ms wall, device busy {busy:.2f} ms, idle share '
              f'{1 - busy / profiled:.3f}; unit-gram launches per value+grad {per_step:.0f}, their '
              f'kernels {gram_ms:.3f} ms; peak device memory {peak:.2f} GiB; top kernels:',
              flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f'    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}',
                  flush=True)
        require(per_step == (1 if route == 'lengthscales trainable' else 0), (route, per_step))


#: The margin over each first-order estimate of a float32 or float64 rounding
#: error in check_covariant_gradients.
FIRST_ORDER_MARGIN = 10
EPS = {'float32': 2.0 ** -23, 'float64': 2.0 ** -52}


def check_covariant_gradients(torch, gram_kernels, repo):
    """Phase 7, at L*N = 12288 (folds 0 and 1), on the trained parameters:
    lml(F, noise_cov) and its gradients in F and noise_cov through
    CovariantUpperLML, in float32 (unit gram from the kernel) and in float64
    (plain unit gram), each against autograd through the float64 Cholesky of
    the plainly built K, on the same F, noise_cov, lengthscales and inputs.

    The limits come from the measured spectrum of the float64 K: a
    perturbation dK of norm eps lam_max moves the LML by at most
    1/2 ||dK|| (tr K^-1 + ||alpha||^2), and each entry of dLML/dF and
    dLML/dnoise_cov, 1/2 tr(W dK/dF_ij) with W = alpha alpha^T - K^-1 and
    ||dK/dF_ij||_* <= N, by at most 1/2 N ||dW||, with ||dW|| <= eps cond(K)
    (1/lam_min + 2 ||alpha||^2); FIRST_ORDER_MARGIN times each is the limit.
    The float64 limits hold the analytic backward at these shapes; the
    float32 gradient limit is loose wherever cond(K) is large."""
    import numpy as np
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models import gp, params
    from romcomma_tpu_torch.ops.gram import rbf_gram_covariant
    from romcomma_tpu_torch.ops.linalg import cholesky, mvn_logpdf
    worst, failures = 0.0, []
    for k in (0, 1):
        fold = Fold(repo, k)
        raw, _, _, _ = trained_covariant(torch, fold.folder / 'gpr.c.a', CARD, torch.float32)
        with torch.no_grad():
            c32 = params.covariant_constrain(raw)
        X, Y = fold_tensors(torch, fold, torch.float32)
        LN, N = X.shape[0] * Y.shape[1], X.shape[0]
        ls64, X64, Y64 = c32['lengthscales'].double(), X.double(), Y.double()
        yy64 = Y64.T.reshape(-1, 1)

        def value_and_grads(lml, F, noise_cov):
            F, noise_cov = (t.detach().clone().requires_grad_(True) for t in (F, noise_cov))
            value = lml(F, noise_cov)
            return [value.detach().double()] + [g.double() for g in
                                                torch.autograd.grad(value, [F, noise_cov])]

        def autograd_lml(F, noise_cov):
            K = gp._add_noise(rbf_gram_covariant(X64, X64, ls64, F), noise_cov)
            return torch.sum(mvn_logpdf(yy64, torch.zeros_like(yy64), cholesky(K)))

        launches = gram_kernels.LAUNCHES
        readings = {'float32': value_and_grads(gp.covariant_upper_lml(X, c32['lengthscales'], Y),
                                               c32['F'], c32['noise_cov'])}
        require(gram_kernels.LAUNCHES == launches + 1, 'the float32 unit gram missed the kernel')
        F64, noise64 = c32['F'].double(), c32['noise_cov'].double()
        readings['float64'] = value_and_grads(gp.covariant_upper_lml(X64, ls64, Y64), F64, noise64)
        want = value_and_grads(autograd_lml, F64, noise64)
        with torch.no_grad():
            K = gp._add_noise(rbf_gram_covariant(X64, X64, ls64, F64), noise64)
            alpha2 = float(torch.sum(yy64 * torch.cholesky_solve(yy64, torch.linalg.cholesky(K))))
            lam = torch.linalg.eigvalsh(K)
            del K
        lam_min, lam_max = float(lam[0]), float(lam[-1])
        tr_inv = float(torch.sum(1.0 / lam))
        cond = lam_max / lam_min if lam_min > 0 else math.inf
        print(f'fold {k} L*N={LN}: float64 K has lam_min {lam_min:.4e}, lam_max {lam_max:.4e}, '
              f'cond {cond:.4e}, tr K^-1 {tr_inv:.4e}, ||alpha||^2 {alpha2:.4e}', flush=True)
        for label, got in readings.items():
            eps = EPS[label]
            limits = [FIRST_ORDER_MARGIN * 0.5 * eps * lam_max * (tr_inv + alpha2)]
            limits += 2 * [FIRST_ORDER_MARGIN * 0.5 * N * eps * cond * (1 / lam_min + 2 * alpha2)]
            errors = [float((g - w).abs().max()) for g, w in zip(got, want)]
            ratios = [e / limit for e, limit in zip(errors, limits)]
            worst = max(worst, *ratios)
            print(f'  CovariantUpperLML {label} against float64 autograd: LML '
                  f'{got[0].item():.6f} vs {want[0].item():.6f}, |diff| {errors[0]:.3e} '
                  f'(limit {limits[0]:.3e}); dF max |diff| {errors[1]:.3e} of max |dF| '
                  f'{float(want[1].abs().max()):.3e}, dnoise max |diff| {errors[2]:.3e} of max '
                  f'|dnoise| {float(want[2].abs().max()):.3e} (limit {limits[1]:.3e})', flush=True)
            if not all(math.isfinite(e) and e <= limit for e, limit in zip(errors, limits)):
                failures.append((k, label, errors, limits))
    require(not failures, failures)
    return worst


def covariant_gsa(torch, user, gram_kernels, repo):
    """Phase 7: run.gsa on the trained covariant models, all kinds, without
    errors (romcomma_tpu cannot compute them for a covariant model)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, t0 = gram_kernels.LAUNCHES, time.perf_counter()
    names = user.run.gsa('gpr', repo, kinds=user.run.GSA.ALL_KINDS, is_error_calculated=False,
                         **COVARIANT_OPTIONS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f'run.gsa covariant: {seconds:.2f} s for folds {list(repo.folds)}, names '
          f'{[str(n) for n in names]}; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; unit-gram kernel launches '
          f'{gram_kernels.LAUNCHES - launches}', flush=True)
    check_gsa_tree(repo, 'gpr.c.a', 'SV')
    return seconds


def covariant_tables(torch, raw, X, Y, xs, F, lengthscales, on):
    """From float64 inputs, on `on`: the covariant LML, its gradient in every
    raw leaf, predict_covariant's mean and variance at xs, and the GSA's S
    and V of every kind (F non-diagonal) and of the full slice. On the host."""
    from romcomma_tpu_torch.gsa.calibrators import ClosedSobol
    from romcomma_tpu_torch.models import gp, params
    p = {n: t.to(on).requires_grad_(True) for n, t in raw.items()}
    x, y, xt = (torch.tensor(a, dtype=torch.float64, device=on) for a in (X, Y, xs))
    lml = gp.lml_covariant(p, x, y)
    grads = torch.autograd.grad(lml, [p[n] for n in params.COVARIANT_FIELDS])
    tables = {'lml': lml} | {f'd lml / d {n}': g for n, g in zip(params.COVARIANT_FIELDS, grads)}
    with torch.no_grad():
        fixed = {n: t.detach() for n, t in p.items()}
        tables['mean'], tables['var'] = gp.predict_covariant(fixed, x, y, xt)
        K_cho, K_inv_Y = gp.posterior_factors_covariant(fixed, x, y)
        L, M_ = len(F), X.shape[1]
        cal = ClosedSobol.from_arrays(F, K_cho, K_inv_Y, lengthscales, x, is_F_diagonal=False,
                                      L=L, M=M_, N=X.shape[0])
        slices = tuple(slice_of(m, M_) for slice_of in SLICE_KINDS.values() for m in range(M_))
        out = cal.marginalize_intervals(slices)
        for i, kind in enumerate(SLICE_KINDS):
            for key in 'SV':
                tables[f'{kind} {key}'] = out[key][..., i * M_:(i + 1) * M_]
        tables['full S'], tables['full V'] = cal.S, cal.V[0]
    return {key: value.detach().cpu().numpy() for key, value in tables.items()}


def covariant_card_against_cpu(torch, user):
    """Phase 7, the reference check at the installation test's size
    (OAKLEY2004, N=300, M=7, L=3, K=2): run.gpr variant then covariant on the
    card in float32 with the kernel covariance trained, so F is
    non-diagonal; then for each fold, from the same float64 inputs on both
    devices, the LML, its gradient, the predictions at the test points and
    the GSA's S and V, held within CARD_CPU_TOL of each table's largest
    entry on the CPU."""
    import numpy as np
    from romcomma_tpu_torch.data.storage import Fold
    root = ROOT / 'build' / 'chip_smoke_covariant'
    shutil.rmtree(root, ignore_errors=True)
    np_seed(SEED)
    noise = user.sample.GaussianNoise.Variance(L=len(user.functions.OAKLEY2004), magnitude=0.04)
    repo = user.sample.Function(root, user.sample.DOE.latin_hypercube, user.functions.OAKLEY2004,
                                N=INSTALLATION_N, M=INSTALLATION_M, noise_variance=noise,
                                overwrite_existing=True, seed=SEED).repo.into_K_folds(K)
    t0 = time.perf_counter()
    names = user.run.gpr('gpr', repo, is_read=False, is_covariant=None, is_isotropic=None,
                         maxiter=MAXITER, kernel={'covariance': True})
    print(f'installation size N={INSTALLATION_N} M={INSTALLATION_M}: run.gpr {names} on the card '
          f'(kernel covariance trained) {time.perf_counter() - t0:.2f} s', flush=True)
    worst = {}
    for k in repo.folds:
        fold = Fold(repo, k)
        raw, F, ls, _ = trained_covariant(torch, fold.folder / 'gpr.c.a', 'cpu', torch.float64)
        require(np.abs(F - np.diag(np.diag(F))).max() > 0, f'fold {k}: F is diagonal: {F}')
        inputs = (raw, fold.X.to_numpy(dtype=float), fold.Y.to_numpy(dtype=float),
                  fold.test_x.to_numpy(dtype=float), F, ls)
        card = covariant_tables(torch, *inputs, on=CARD)
        with user.contexts.Environment('the covariant tables on the CPU', device='CPU'):
            cpu = covariant_tables(torch, *inputs, on='cpu')
        errors = {}
        for key, want in cpu.items():
            require(bool(np.isfinite(card[key]).all()), f'fold {k}: {key} is not finite')
            errors[key] = float(np.abs(card[key] - want).max()) / (float(np.abs(want).max()) or 1.0)
            worst[key] = max(worst.get(key, 0.0), errors[key])
        print(f'fold {k} N={fold.N}: F off-diagonal up to {np.abs(F - np.diag(np.diag(F))).max():.4f}; '
              f'worst |card - CPU| / max |CPU|: ' + ', '.join(f'{key} {e:.2e}'
                                                             for key, e in errors.items()),
              flush=True)
    print(f'card against the CPU, covariant, largest over folds: {max(worst.values()):.3e} '
          f'(limit {CARD_CPU_TOL}) at {max(worst, key=worst.get)}', flush=True)
    require(max(worst.values()) <= CARD_CPU_TOL, worst)


#: Phase 8a: benchmarks/north_star.py's problem at its full size, trained to
#: convergence (maxiter is the reference's cap).
NORTH_STAR = (20000, 30, 5000)
#: romcomma_tpu's record of that run on a TPU (BENCH_r05.json): 16 iterations
#: to LML 16636.7109375 and S1_first3 [0.4447, 0.5549, 0.0]. The port's
#: float32 descent ends at a higher LML whose S1 lies about 0.012 from that
#: record. Why romcomma_tpu's descent stopped lower is not measured: the
#: record gives no stop reason, and no run of romcomma_tpu was repeated. So
#: the port's indices are held to the problem's own: for Y = sin(x0) +
#: x1^2 / 2 + noise with x ~ N(0, I), Var sin(x0) = (1 - e^-2) / 2 and
#: Var x1^2 / 2 = 1 / 2, so S1 = [0.46371, 0.53629, 0]; its LML to the
#: record's, which it must reach; and the float32 optimum to a float64
#: descent warm-started from it, whose indices must agree. The distance to
#: the record is printed.
NORTH_STAR_REFERENCE_S1, NORTH_STAR_REFERENCE_LML = (0.4447, 0.5549, 0.0), 16636.7109375
NORTH_STAR_S1 = tuple(v / ((1 - math.exp(-2)) / 2 + 0.5) for v in ((1 - math.exp(-2)) / 2, 0.5, 0.0))
NORTH_STAR_S1_TOL = 0.01
#: Phase 8b: a repository whose improper fold reaches the large route
#: (LARGE_N >= MOGP.LARGE_N_THRESHOLD) while its K proper folds do not.
LARGE_N, LARGE_K, LARGE_MAXITER = 10240, 2, 20
#: Phase 8c: the size of the card-against-CPU check of DistributedGP.
CARD_CPU_N, CARD_CPU_M = 1024, 10


@contextmanager
def distributed_records(torch):
    """Record every DistributedGP.calibrate and calibrate_multi: its rows,
    method, dtype and returned LMLs. The methods are restored on exit."""
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    records = []
    originals = {name: getattr(DistributedGP, name) for name in ('calibrate', 'calibrate_multi')}

    def recorded(name, method):
        def wrapper(self, *args, **kwargs):
            out = method(self, *args, **kwargs)
            lml = out[1].cpu().numpy() if torch.is_tensor(out[1]) else out[1]
            records.append({'N': self.N, 'method': name, 'dtype': self.dtype,
                            'lml': lml, 'iterations': out[2]})
            return out
        return wrapper

    for name, method in originals.items():
        setattr(DistributedGP, name, recorded(name, method))
    try:
        yield records
    finally:
        for name, method in originals.items():
            setattr(DistributedGP, name, method)


def device_time_shares(torch, step):
    """One ExactLML value+grad under torch.profiler: its wall ms, device
    busy ms, and the device ms of the unit-gram kernels, of cuSOLVER's potrf
    (the op linalg_cholesky_ex), of the backward (ExactLMLBackward: its
    cholesky_inverse, which the trace nests in an op of the same name, and
    the gradient reductions), of GEMM and of trsm kernels; then the top
    kernels and ops."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        print(f'  profiled {wall:.2f} ms wall; the trace recorded no device activity', flush=True)
        return wall, busy, {}

    def kernel_ms(*names):
        return sum(e.self_device_time_total for e in kernels
                   if any(n in e.key.lower() for n in names)) / 1e3

    def op_ms(name):
        return sum(e.device_time_total for e in ops if e.key == name) / 1e3

    shares = {'unit-gram kernels': kernel_ms(*KERNEL_NAMES),
              'potrf (aten::linalg_cholesky_ex)': op_ms('aten::linalg_cholesky_ex'),
              'backward (ExactLMLBackward)': op_ms('ExactLMLBackward'),
              'GEMM kernels': kernel_ms('gemm'), 'trsm kernels': kernel_ms('trsm')}
    print(f'  profiled {wall:.2f} ms wall, device busy {busy:.2f} ms, idle share '
          f'{1 - busy / wall:.3f}; device ms (share of busy): ' + ', '.join(
              f'{k} {v:.3f} ({v / busy:.3f})' if v > 0 else f'{k} not in the trace'
              for k, v in shares.items()), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f'    kernel {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}',
              flush=True)
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:8]:
        print(f'    op     {e.device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}',
              flush=True)
    return wall, busy, shares


def _engine_launches(dgp) -> int:
    """Unit-gram launches of one float32 value+grad of dgp on one device:
    for 'upper' the gram, then its n strips' pair tiles, n (n + 1) / 2 (n
    strips with GRAD_PAIR_TILES off); for the engines the gram's float32
    strips (ceil(Npad / TILE_STRIP_ROWS), written into the float64 gram),
    then the gram once more for 'cyclic' (or its gram rows strip by strip
    past the memory budget), or the pair tiles of NS super panels,
    NS (NS + 1) / 2, for 'cyclic2'."""
    _, count = dgp.grad_strip()
    if dgp.engine == 'upper':
        return 1 + (count * (count + 1) // 2 if dgp.GRAD_PAIR_TILES else count)
    from romcomma_tpu_torch.parallel.cyclic_deferred import super_sizes
    from romcomma_tpu_torch.parallel.distributed import TILE_STRIP_ROWS
    strips = -(-dgp.plan.Npad // TILE_STRIP_ROWS)
    if dgp.engine == 'cyclic':
        return strips + (count if dgp.grad_route() == 'solves' else 1)
    panels = len(super_sizes(dgp.plan, dgp._ops.q))
    return strips + panels * (panels + 1) // 2


def _valgrad_ms(torch, gram_kernels, dgp, x, y, hypers, n=3):
    """(the mean host-clock ms of n value+grads of dgp at hypers, after one
    untimed; the unit-gram launches of each)."""
    def step():
        p = [t.clone().requires_grad_(True) for t in hypers]
        torch.autograd.grad(dgp.lml(*p, x, y), p)

    step()
    torch.cuda.synchronize()
    before, t0 = gram_kernels.LAUNCHES, time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, (gram_kernels.LAUNCHES - before) / n


def _original_order(dgp, t):
    """A staged (rows, ...) tensor of dgp in the original row order."""
    from romcomma_tpu_torch.parallel.distributed import _from_stored_t
    return t if dgp.plan is None else _from_stored_t(dgp.plan, t)


#: Phase 13's point, where phase 8a also times engine='upper': the optimum
#: of the north star's float32 descent on engine='upper' (ExactLML, all
#: float32) from its start, N=20000, M=30 (``tools/north_star_descents.py``
#: prints it; NVIDIA H100 80GB HBM3, PERF.md). ExactLML float32, phase 13's
#: reference, factorizes there; at the 'cyclic2' route's optimum (s2/noise ~
#: 1.2e4) it breaks down.
NORTH_STAR_UPPER_OPTIMUM = {
    'ls': (3.3341991901397705, 5.206558704376221, 117.9267807006836, 120.92347717285156,
           126.21414184570312, 122.28045654296875, 119.0213394165039, 121.32362365722656,
           118.91744995117188, 123.55664825439453, 120.57200622558594, 124.30779266357422,
           119.53321838378906, 120.8245849609375, 119.1611328125, 120.52678680419922,
           122.14530944824219, 118.35286712646484, 120.618896484375, 119.43183898925781,
           122.6192855834961, 123.26801300048828, 123.48995208740234, 122.56403350830078,
           121.54754638671875, 120.69462585449219, 120.63131713867188, 121.17060852050781,
           121.3062973022461, 120.42841339111328),
    's2': 15.736834526062012,
    'noise': 0.010294073261320591}


def upper_hypers():
    """NORTH_STAR_UPPER_OPTIMUM as (ls (M,), s2, noise), float32 numpy."""
    import numpy as np
    o = NORTH_STAR_UPPER_OPTIMUM
    return (np.asarray(o['ls'], dtype=np.float32), np.float32(o['s2']), np.float32(o['noise']))


def north_star_phase(torch, gram_kernels):
    """Phase 8a: the north star on the card in float32 on its production
    route ('cyclic2' from N = CYCLIC2_SINGLE_CHIP_MIN_N), its unit-gram
    launches counted; its S1 against the problem's own; its optimum against
    romcomma_tpu's LML and a float64 descent (engine='upper') warm-started
    from it; the float64 posterior's residual; one value+grad timed at
    its optimum, and at NORTH_STAR_UPPER_OPTIMUM beside engine='upper''s
    there; the production one profiled."""
    import numpy as np
    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.ops.gram import rbf_gram
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    N_, M_, maxiter = NORTH_STAR
    torch.cuda.synchronize()
    gram_kernels.LAUNCHES = 0
    out, state = north_star.run(N_, M_, maxiter)
    launches = gram_kernels.LAUNCHES
    print(json.dumps(out), flush=True)
    error = max(abs(a - b) for a, b in zip(out['S1_first3'], NORTH_STAR_S1))
    reference = max(abs(a - b) for a, b in zip(out['S1_first3'], NORTH_STAR_REFERENCE_S1))
    print(f'north star on the {out["engine"]!r} route: {out["iters"]} iterations, LML '
          f'{out["lml"]:.6f}, unit-gram kernel launches {launches} ({out["train_launches"]} in '
          f'the descent); S1_first3 {out["S1_first3"]} against the problem\'s '
          f'{[round(v, 5) for v in NORTH_STAR_S1]}: max |diff| {error:.4f} (tol '
          f'{NORTH_STAR_S1_TOL}); against romcomma_tpu\'s record {list(NORTH_STAR_REFERENCE_S1)}: '
          f'{reference:.4f}; peak device memory {out["peak_gib"]:.2f} GiB ({out["held_gib"]:.2f} '
          f'held before it), by stage '
          + ', '.join(f'{k} {v:.2f}' for k, v in out['peak_gib_by_stage'].items()), flush=True)
    require(out['engine'] == 'cyclic2', out['engine'])
    require(launches > 0, 'the north star never launched the unit-gram kernel')
    require(math.isfinite(out['lml']), out['lml'])
    require(error <= NORTH_STAR_S1_TOL, (out['S1_first3'], NORTH_STAR_S1))
    dgp, x, y = state['dgp'], state['x_dev'], state['y_dev']
    hypers = tuple(state[k] for k in ('ls', 's2', 'noise'))
    dgp64 = DistributedGP(N_, dtype=np.float64, engine='upper')
    x64s, y64s = dgp64.stage(state['X'], state['Y'])
    at_optimum = dgp64.lml(*hypers, x64s, y64s).item()
    t0 = time.perf_counter()
    hypers64, lml64, iterations64 = dgp64.calibrate(state['X'], state['Y'],
                                                    *(h.double() for h in hypers),
                                                    maxiter=maxiter)
    S64 = dgp64.sobol_indices(*hypers64, x64s, y64s, state['X'], kind='first_order')
    torch.cuda.synchronize()
    moved = max(abs(S64[m] - out['S1_first3'][m]) for m in range(3))
    print(f'float64 LML at the float32 optimum {at_optimum:.6f} (romcomma_tpu\'s optimum '
          f'{NORTH_STAR_REFERENCE_LML}); a float64 descent (engine=\'upper\') warm-started '
          f'there: {iterations64} iterations, LML {lml64:.6f}, S1_first3 '
          f'{[round(S64[m], 4) for m in range(3)]} (max |diff| to float32 {moved:.4f}), '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    require(at_optimum >= NORTH_STAR_REFERENCE_LML and moved <= NORTH_STAR_S1_TOL,
            (at_optimum, lml64, moved))
    del dgp64, x64s, y64s
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alpha, chol = dgp.posterior_alpha(*hypers, x, y)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        del chol
        alpha = _original_order(dgp, alpha)
        x64, y64 = (_original_order(dgp, t).double() for t in (x, y))
        K = rbf_gram(x64, x64, hypers[0].double(), hypers[1].double())
        K.diagonal().add_(hypers[2].double())
        residual = float(torch.linalg.norm(y64 - K @ alpha) / torch.linalg.norm(y64))
        del K
    print(f'float64 posterior ({dgp.engine!r}): alpha in {seconds:.3f} s; |y - K alpha| / |y| = '
          f'{residual:.3e} (ls {hypers[0].cpu().numpy().round(4).tolist()}, s2 '
          f'{hypers[1].item():.6f}, noise {hypers[2].item():.6e})', flush=True)
    require(residual < 1e-6, residual)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, per_step = _valgrad_ms(torch, gram_kernels, dgp, x, y, hypers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    at = tuple(torch.as_tensor(h, device=CARD) for h in upper_hypers())
    there, _ = _valgrad_ms(torch, gram_kernels, dgp, x, y, at)
    upper = DistributedGP(N_, dtype=np.float32, engine='upper')
    xu, yu = upper.stage(state['X'], state['Y'])
    upper_wall, upper_step = _valgrad_ms(torch, gram_kernels, upper, xu, yu, at)
    del xu, yu
    print(f'N={N_}: one float32 value+grad on the {dgp.engine!r} route at its optimum '
          f'({out["iters"]} iterations) {wall:.2f} ms wall (mean of 3), {per_step:.0f} unit-gram '
          f'launches per step, peak device memory {peak:.2f} GiB; at NORTH_STAR_UPPER_OPTIMUM '
          f'{there:.2f} ms, engine=\'upper\' (streaming) there {upper_wall:.2f} ms, '
          f'{upper_step:.0f} launches: {there / upper_wall:.3f} of it', flush=True)
    require(per_step == _engine_launches(dgp) and upper_step == _engine_launches(upper),
            (per_step, upper_step))
    del upper

    def step():
        p = [t.clone().requires_grad_(True) for t in hypers]
        torch.autograd.grad(dgp.lml(*p, x, y), p)

    device_time_shares(torch, step)
    return launches


#: Phase 8d: the north star at N=50000 on one card ('cyclic2', Npad 50176),
#: its descent cut at NORTH_STAR_LARGE[2] iterations (romcomma_tpu converged
#: in 15 there).
NORTH_STAR_LARGE = (50000, 30, 30)
#: The ring tile's first row whose output offset, row x Npad, passes 2^31
#: floats, and the 128-row strips past it held to the plain version.
STRIP_ROWS = 128


def engine_stages(torch, dgp, x, y, hypers) -> dict:
    """One value+grad of a one-device 'cyclic2' dgp at hypers, stage by
    stage as ``MeshLML`` runs it: {stage: (host-clock s, peak device GiB in
    that stage)}, the stages the ring gram (float32 strips through the
    kernel, written into the float64 gram, the noise added there), the
    factor, the solves and log-det,
    the in-place inverse and the pair sweep; each stage's peak counts what
    it holds with what came before it."""
    ops, stages = dgp._ops, {}
    ls, s2, noise = (h.detach() for h in hypers)

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30)
        return result

    with torch.no_grad():
        K = timed('ring gram', lambda: ops.gram(x, ls, s2, noise, torch.float64))
        F = timed('factor', lambda: ops.chol(K))
        del K
        alpha = timed('solves', lambda: (ops.bwd(F, ops.fwd(F, y.to(F.dtype))),
                                         ops.logdiag(F)))[0]
        V = timed('in-place inverse', lambda: ops.residual(F))
        del F
        timed('pair sweep', lambda: ops.grads(V, alpha, x, ls, s2, noise))
        del V
    return stages


def check_large_tile(torch, gram_kernels, x, ls):
    """The unit-gram kernel at 8d's shapes from its scaled rows: the last
    strip of the gram as the route launches it (TILE_STRIP_ROWS rows
    against all Npad, two operands) against the plain version; the whole
    ring tile (Npad^2, M) u is v, whose output passes 2^31 floats: its
    128-row strips at and past the row where it does, and the last, against
    the plain version; its forward timed (CUDA events) beside the plain
    one's and its bound. Returns the max |kernel - plain| of all of them."""
    from romcomma_tpu_torch.parallel.distributed import TILE_STRIP_ROWS
    u = (x / ls).contiguous()
    Npad, M_ = u.shape
    last = u[Npad - TILE_STRIP_ROWS:]
    strip_err = (gram_kernels.unit_gram_cuda(last, u)
                 - gram_kernels.unit_gram_plain(last, u)).abs().max().item()
    (strip_ms,), (strip_plain,) = (
        spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(last, u)], samples=10, calls=2),
        spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(last, u)], samples=3, calls=1))
    strip_bound, strip_by = forward_bound_ms(TILE_STRIP_ROWS, Npad, M_, shared=False)
    mark = (2 ** 31) // Npad
    starts = sorted(r0 for r0 in {0, mark // STRIP_ROWS * STRIP_ROWS,
                                  (mark + 1024) // STRIP_ROWS * STRIP_ROWS, Npad - STRIP_ROWS}
                    if r0 + STRIP_ROWS <= Npad)
    E = gram_kernels.unit_gram_cuda(u, u)
    torch.cuda.synchronize()
    errors = {}
    for r0 in starts:
        plain = gram_kernels.unit_gram_plain(u[r0:r0 + STRIP_ROWS], u)
        errors[r0] = (E[r0:r0 + STRIP_ROWS] - plain).abs().max().item()
        require(bool(torch.isfinite(E[r0:r0 + STRIP_ROWS]).all()), ('strip', r0))
    del E, plain
    (kernel,) = spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, u)], samples=5, calls=1,
                          warmup=1)
    torch.cuda.empty_cache()
    (plain_ms,) = spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, u)], samples=1,
                            calls=1, warmup=0)
    bound, bound_by = forward_bound_ms(Npad, Npad, M_, shared=True)
    err = max(strip_err, *errors.values())
    print(f'the route\'s last gram strip ({TILE_STRIP_ROWS} x {Npad}, {M_}), two operands: max '
          f'|kernel - plain| {strip_err:.3e}, forward ms kernel median {strip_ms[1]:.4f} (min '
          f'{strip_ms[0]:.4f}), plain {strip_plain[1]:.4f}, bound {strip_bound:.4f} ms '
          f'({strip_by}), kernel at {strip_bound / strip_ms[1]:.3f} of it; ring tile ({Npad}^2, '
          f'{M_}), u is v: '
          f'{Npad * Npad:.4e} floats, row {mark} the first '
          f'past 2^31; max |kernel - plain| of the {STRIP_ROWS}-row strips from rows '
          + ', '.join(f'{r0}: {e:.3e}' for r0, e in errors.items()) + f' (tol {VALUE_TOL}); '
          f'forward ms kernel min / median / max {kernel[0]:.4f} / {kernel[1]:.4f} / '
          f'{kernel[2]:.4f} (5 calls), plain {plain_ms[1]:.4f}; bound {bound:.4f} ms '
          f'({bound_by}), kernel at {bound / kernel[1]:.3f} of it', flush=True)
    require(err <= VALUE_TOL, (strip_err, errors))
    return err


def north_star_large_phase(torch, gram_kernels):
    """Phase 8d: the north star at N=50000, M=30 on one card, float32, on
    its production route ('cyclic2'): at most NORTH_STAR_LARGE[2]
    iterations, the GSA of both kinds without errors, S1 within
    NORTH_STAR_S1_TOL of the problem's own, the float32 LML at the start
    within phase 4's bound of the float64 one, one value+grad stage by stage
    (time and peak memory), the float64 posterior's peak, and the ring
    tile's strips past 2^31 floats against the plain version. Returns (the
    unit-gram launches of the run, the strips' max |kernel - plain|)."""
    import numpy as np
    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    N_, M_, maxiter = NORTH_STAR_LARGE
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gram_kernels.LAUNCHES = 0
    out, state = north_star.run(N_, M_, maxiter)
    launches = gram_kernels.LAUNCHES
    print(json.dumps(out), flush=True)
    dgp, x, y = state['dgp'], state['x_dev'], state['y_dev']
    hypers = tuple(state[k] for k in ('ls', 's2', 'noise'))
    error = max(abs(a - b) for a, b in zip(out['S1_first3'], NORTH_STAR_S1))
    print(f'north star N={N_} on the {out["engine"]!r} route (Npad {dgp.plan.Npad}, '
          f'{_engine_launches(dgp)} unit-gram launches per value+grad): {out["iters"]} '
          f'iterations (at most {maxiter}), LML '
          f'{out["lml"]:.6f}, train {out["train_s"]:.2f} s, value+grad {out["valgrad_s"]:.3f} s, '
          f'GSA of both kinds {out["gsa_both_kinds_s"]:.2f} s (warm '
          f'{out["gsa_both_kinds_warm_s"]:.2f} s), end to end {out["end_to_end_s"]:.2f} s; '
          f'unit-gram launches {launches} ({out["train_launches"]} in the descent); S1_first3 '
          f'{out["S1_first3"]} against the problem\'s {[round(v, 5) for v in NORTH_STAR_S1]}: '
          f'max |diff| {error:.4f} (tol {NORTH_STAR_S1_TOL}); peak device memory '
          f'{out["peak_gib"]:.2f} GiB ({out["held_gib"]:.2f} held before it), by stage '
          + ', '.join(f'{k} {v:.2f}' for k, v in out['peak_gib_by_stage'].items()), flush=True)
    require(out['engine'] == 'cyclic2' and launches > 0, (out['engine'], launches))
    require(out['iters'] <= maxiter and math.isfinite(out['lml']), (out['iters'], out['lml']))
    require(error <= NORTH_STAR_S1_TOL, (out['S1_first3'], NORTH_STAR_S1))
    start = (torch.full((M_,), 2.0, device=CARD), torch.tensor(1.0, device=CARD),
             torch.tensor(0.05, device=CARD))
    with torch.no_grad():
        lml32 = dgp.lml(*start, x, y).item()
    dgp64 = DistributedGP(N_, dtype=np.float64, dense_kernels=True)
    x64, y64 = dgp64.stage(state['X'], state['Y'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        lml64 = dgp64.lml(*(t.double() for t in start), x64, y64).item()
    torch.cuda.synchronize()
    seconds64, peak64 = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30
    del dgp64, x64, y64
    bound = 10 * N_ * EPS['float32'] * (1.0 / 0.05 + 1.0)
    print(f'at the start (ls 2, s2 1, noise 0.05): LML float32 {lml32:.6f}, float64 '
          f'{lml64:.6f} ({dgp.engine!r} in float64, {seconds64:.2f} s, peak {peak64:.2f} GiB); '
          f'|diff| {abs(lml32 - lml64):.3e} (phase 4 bound {bound:.3e})', flush=True)
    require(abs(lml32 - lml64) <= bound, (lml32, lml64, bound))
    stages = engine_stages(torch, dgp, x, y, hypers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        alpha, chol = dgp.posterior_alpha(*hypers, x, y)
        torch.cuda.synchronize()
        stages['float64 posterior'] = (time.perf_counter() - t0,
                                       torch.cuda.max_memory_allocated() / 2 ** 30)
        del alpha, chol
    print(f'N={N_} float32 value+grad on {dgp.engine!r} stage by stage (s, peak GiB): '
          + ', '.join(f'{k} {t:.3f} s {p:.2f} GiB' for k, (t, p) in stages.items()), flush=True)
    return launches, check_large_tile(torch, gram_kernels, x, hypers[0].detach())


#: Phase 8e, the one-device streaming gradient: 'upper' against ExactLML at
#: the north star's N; 'upper' forced at N=50000; 'cyclic' past
#: GRADS_MEMORY_BUDGET_BYTES, in float32 at N=50000 and in float64 (the
#: large route's rescue engine) at N=24000, each against 'cyclic2'.
STREAM_N, STREAM_LARGE_N, STREAM_RESCUE_N = 20000, 50000, 24000
#: The kernel at the streaming gradient's shapes, two operands: a pair tile
#: and a strip's gram rows against all Npad = 50176 rows.
STREAM_TILE_SHAPES = ((2048, 2048, 30, False), (2048, 50176, 30, False))
#: 'upper''s float32 LML, dls, ds2 and dnoise at NORTH_STAR_UPPER_OPTIMUM
#: against float64 ExactLML: within these multiples of ExactLML float32's
#: own distance from float64 there, and its pair tiles against its 'vvt'
#: strips within the same. Set from the H100's first reading (PERF.md):
#: 1.06, 0.86, 13.1, 1.04 (pair tiles), 1.06, 0.95, 37.9, 1.04 ('vvt'
#: strips), 0, 0.09, 24.8, 0.0003 (one against the other); ds2, sum(Bbar o
#: Knn) over K^-1 formed as V V^T in float32, is the least accurate, as over
#: several ranks (MESH_RANKS_F32_MULTIPLES, whose limits these are).
STREAM_F32_MULTIPLES = (4.0, 4.0, 100.0, 4.0)
#: Each one-device 'cyclic' streaming gradient part against 'cyclic2''s at
#: the same point: max |diff| / max |part|.
STREAM_CYCLIC_RTOL = 1e-6


class ExactReference:
    """A one-device DistributedGP (engine='upper') whose ``lml`` is the dense
    exact LML, ``models.gp.ExactLML`` (the gram, its factor and
    cholesky_inverse's K^-1: three (N, N) buffers), which the small route
    and a fold group evaluate: the reference phases 8b, 8e and 13 hold the
    large route's engines to. Everything else is the engine's."""

    def __init__(self, gp):
        self.gp = gp

    def lml(self, ls, s2, noise, x, y):
        from romcomma_tpu_torch.models.gp import ExactLML
        return ExactLML.apply(*self.gp._cast(x, ls, s2, noise), x, y)

    def __getattr__(self, name):
        return getattr(self.gp, name)


def streaming_valgrad(torch, gram_kernels, gp, x, y, at, n=0):
    """One value+grad of gp at the hyperparameters `at`, measured: {'parts':
    [LML, dls, ds2, dnoise] in float64, 'held': GiB allocated after the
    forward above what was held before it, 'peak': the value+grad's peak
    GiB above that, 'launches': its unit-gram launches, 'ms': its host-clock
    ms, or the median of n more where n > 0}."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches, t0 = gram_kernels.LAUNCHES, time.perf_counter()
    p = [t.detach().clone().requires_grad_(True) for t in at]
    value = gp.lml(*p, x, y)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    grads = torch.autograd.grad(value, p)
    torch.cuda.synchronize()
    out = {'ms': (time.perf_counter() - t0) * 1e3, 'held': held / 2 ** 30,
           'peak': (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
           'launches': gram_kernels.LAUNCHES - launches,
           'parts': [value.detach().double()] + [g.double() for g in grads]}
    del value, grads, p
    if n:
        out['ms'] = median_ms(torch, lambda: _value_and_grad(torch, gp, x, y, at), n)
    return out


def _relative(got, want) -> list:
    """max |got - want| / max |want| of each part."""
    return [float((g - w).abs().max()) / (float(w.abs().max()) or 1.0) for g, w in zip(got, want)]


def _reading(label, r) -> str:
    return (f'{label}: {r["ms"]:.2f} ms, held after the forward {r["held"]:.3f} GiB, peak '
            f'{r["peak"]:.3f} GiB above what was held, {r["launches"]} unit-gram launches')


def check_stream_tiles(torch, gram_kernels):
    """The kernel at STREAM_TILE_SHAPES against its plain version, timed
    (CUDA events) beside the plain one and its bound. Returns {shape: (ms,
    plain ms, bound ms, bound by, max |kernel - plain|)}."""
    times = {}
    for A, B, M_, shared in STREAM_TILE_SHAPES:
        u, v = unit_inputs(torch, A, B, M_, seed=B + 3, shared=shared)
        err = (gram_kernels.unit_gram_cuda(u, v) - gram_kernels.unit_gram_plain(u, v)
               ).abs().max().item()
        (kernel,), (plain,) = (spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, v)],
                                         samples=20, calls=5),
                               spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, v)],
                                         samples=5, calls=2))
        bound, bound_by = forward_bound_ms(A, B, M_, shared)
        times[(A, B, M_, shared)] = (kernel[1], plain[1], bound, bound_by, err)
        print(f'streaming tile ({A}, {B}, {M_}, two operands): max |kernel - plain| {err:.3e} '
              f'(tol {VALUE_TOL}); forward ms kernel min / median / max {kernel[0]:.4f} / '
              f'{kernel[1]:.4f} / {kernel[2]:.4f} (20 samples of 5), plain median '
              f'{plain[1]:.4f}; bound {bound:.4f} ms ({bound_by}), kernel at '
              f'{bound / kernel[1]:.3f} of it', flush=True)
        require(err <= VALUE_TOL, (A, B, M_, err))
        del u, v
    return times


def streaming_phase(torch, gram_kernels):
    """Phase 8e: the one-device streaming LML gradient on the card, float32
    unless named. At the north star's problem at N=STREAM_N and
    NORTH_STAR_UPPER_OPTIMUM: engine='upper' (the in-place inverse, V kept,
    the pair tiles) against ExactLML float32 and float64, its LML parts
    within STREAM_F32_MULTIPLES of ExactLML float32's own distance from
    float64, its 'vvt' strips against its pair tiles within the same, at
    MESH_START its LML within phase 4's bound of float64 ExactLML's; the
    memory each holds after its forward and its peak. At N=STREAM_LARGE_N:
    'upper' forced, holding V and O(Npad strip) after its forward, beside
    ExactLML; 'cyclic' past the budget (the identity-column strips) against
    'cyclic2' at the same point; at N=STREAM_RESCUE_N the float64 'cyclic'
    of the large route's rescue against float64 'cyclic2': each gradient
    part within STREAM_CYCLIC_RTOL. The kernel at the new shapes against
    its plain version. Returns (the unit-gram launches of the streaming
    routes' value+grads, the shapes' times)."""
    import numpy as np
    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    tiles = check_stream_tiles(torch, gram_kernels)
    failures = []
    M_ = NORTH_STAR[1]

    def hypers(values, dtype):
        return tuple(torch.as_tensor(np.asarray(v), dtype=dtype, device=CARD) for v in values)

    start = (np.full(M_, MESH_START[0]), *MESH_START[1:])
    X, Y = north_star.problem(STREAM_N, M_)
    at = hypers(upper_hypers(), torch.float32)
    exact = ExactReference(DistributedGP(STREAM_N, CARD, dtype=np.float32, engine='upper'))
    x, y = exact.stage(X, Y)
    r = {'ExactLML float32': streaming_valgrad(torch, gram_kernels, exact, x, y, at, n=3)}
    exact64 = ExactReference(DistributedGP(STREAM_N, CARD, dtype=np.float64, engine='upper'))
    x64, y64 = exact64.stage(x, y)
    r['ExactLML float64'] = streaming_valgrad(torch, gram_kernels, exact64, x64, y64,
                                              tuple(t.double() for t in at))
    with torch.no_grad():
        start64 = exact64.lml(*hypers(start, torch.float64), x64, y64).item()
    del exact64, x64, y64
    upper = DistributedGP(STREAM_N, CARD, dtype=np.float32, engine='upper')
    r['upper, pair tiles'] = streaming_valgrad(torch, gram_kernels, upper, x, y, at, n=3)
    upper.GRAD_PAIR_TILES = False
    r['upper, vvt strips'] = streaming_valgrad(torch, gram_kernels, upper, x, y, at, n=3)
    with torch.no_grad():
        start32 = upper.lml(*hypers(start, torch.float32), x, y).item()
    upper.GRAD_PAIR_TILES = True
    f64 = r['ExactLML float64']['parts']
    reference = _apart(r['ExactLML float32']['parts'], f64)
    apart = {label: _apart(r[label]['parts'], f64) for label in ('upper, pair tiles',
                                                                 'upper, vvt strips')}
    apart['pair tiles against vvt strips'] = _apart(r['upper, pair tiles']['parts'],
                                                    r['upper, vvt strips']['parts'])
    strip, count = upper.grad_strip()
    V_gib = upper._upper.plan.Npad ** 2 * 4 / 2 ** 30
    slack_gib = 4 * upper._upper.plan.Npad * strip * 4 / 2 ** 30
    bound = 10 * STREAM_N * EPS['float32'] * (1.0 / MESH_START[2] + 1.0)
    print(f'N={STREAM_N} at NORTH_STAR_UPPER_OPTIMUM (Npad {upper._upper.plan.Npad}, strips of '
          f'{strip}: {count * (count + 1) // 2} pair tiles, V {V_gib:.3f} GiB): ExactLML float32 '
          f'against float64 {_parts(reference)}; '
          + '; '.join(f'{label} {_parts(a)} (multiples ' + ', '.join(
              f'{v / w:.3f}' for v, w in zip(a, reference)) + ')' for label, a in apart.items())
          + f' (limits {STREAM_F32_MULTIPLES}); at MESH_START LML float32 {start32:.6f}, float64 '
          f'ExactLML {start64:.6f}, |diff| {abs(start32 - start64):.3e} (phase 4 bound '
          f'{bound:.3e})', flush=True)
    for label, reading in r.items():
        print(f'  {_reading(label, reading)}', flush=True)
    for label, a in apart.items():
        if not all(v <= m * w for v, m, w in zip(a, STREAM_F32_MULTIPLES, reference)):
            failures.append((label, a, reference))
    if abs(start32 - start64) > bound:
        failures.append(('LML at MESH_START', start32, start64, bound))
    if r['upper, pair tiles']['held'] > V_gib + slack_gib:
        failures.append(('upper holds more than V', r['upper, pair tiles']['held'], V_gib))
    launches = (r['upper, pair tiles']['launches'], r['upper, vvt strips']['launches'])
    if launches != (1 + count * (count + 1) // 2, 1 + count):
        failures.append(('launches', launches, count))
    del exact, upper, x, y

    X, Y = north_star.problem(STREAM_LARGE_N, M_)
    large = {}
    for label, engine in (('upper', 'upper'), ('ExactLML', 'upper'), ('cyclic', 'cyclic'),
                          ('cyclic2', 'cyclic2')):
        gp = DistributedGP(STREAM_LARGE_N, CARD, dtype=np.float32, engine=engine)
        if label == 'ExactLML':
            gp = ExactReference(gp)
        x, y = gp.stage(X, Y)
        large[label] = streaming_valgrad(torch, gram_kernels, gp, x, y,
                                         hypers(start, torch.float32))
        large[label]['route'] = 'ExactLML' if label == 'ExactLML' else gp.grad_route()
        del gp, x, y
    Npad = -(-STREAM_LARGE_N // 256) * 256
    V_gib = Npad ** 2 * 4 / 2 ** 30
    slack_gib = 4 * Npad * DistributedGP.GRAD_STRIP_COLS * 4 / 2 ** 30
    cyclic = _relative(large['cyclic']['parts'], large['cyclic2']['parts'])
    upper, exact = large['upper'], large['ExactLML']
    print(f'N={STREAM_LARGE_N} at MESH_START (Npad {Npad}, V {V_gib:.3f} GiB): LML upper '
          f'{upper["parts"][0].item():.6f}, ExactLML {exact["parts"][0].item():.6f}, upper '
          f'against ExactLML {_parts(_apart(upper["parts"], exact["parts"]))}; cyclic '
          f'({large["cyclic"]["route"]}) against cyclic2 relative {_parts(cyclic)} (limit '
          f'{STREAM_CYCLIC_RTOL} on the gradient)', flush=True)
    for label, reading in large.items():
        print(f'  {_reading(label + " (" + reading["route"] + ")", reading)}', flush=True)
    if upper['held'] > V_gib + slack_gib or upper['route'] != 'pairs':
        failures.append(('upper at N=50000', upper['held'], V_gib, upper['route']))
    if large['cyclic']['route'] != 'solves' or max(cyclic[1:]) > STREAM_CYCLIC_RTOL:
        failures.append(('cyclic at N=50000', large['cyclic']['route'], cyclic))
    if not all(bool(torch.isfinite(p).all()) for v in large.values() for p in v['parts']):
        failures.append(('non-finite at N=50000', {k: [p.max().item() for p in v['parts']]
                                                   for k, v in large.items()}))
    del X, Y

    X, Y = north_star.problem(STREAM_RESCUE_N, M_)
    rescue = {}
    for label, options in (('cyclic', {}), ('cyclic2', {'engine': 'cyclic2'})):
        gp = DistributedGP(STREAM_RESCUE_N, CARD, dtype=np.float64, **options)
        x, y = gp.stage(X, Y)
        rescue[label] = streaming_valgrad(torch, gram_kernels, gp, x, y,
                                          hypers(start, torch.float64))
        rescue[label]['route'] = gp.grad_route()
        del gp, x, y
    cyclic = _relative(rescue['cyclic']['parts'], rescue['cyclic2']['parts'])
    print(f'N={STREAM_RESCUE_N} float64 at MESH_START: the rescue\'s cyclic '
          f'({rescue["cyclic"]["route"]}) against cyclic2 relative {_parts(cyclic)} (limit '
          f'{STREAM_CYCLIC_RTOL} on the gradient)', flush=True)
    for label, reading in rescue.items():
        print(f'  {_reading(label + " (" + reading["route"] + ")", reading)}', flush=True)
    if rescue['cyclic']['route'] != 'solves' or max(cyclic[1:]) > STREAM_CYCLIC_RTOL:
        failures.append(('the rescue\'s cyclic at N=24000', rescue['cyclic']['route'], cyclic))
    require(not failures, failures)
    streamed = [r['upper, pair tiles'], r['upper, vvt strips'], large['upper'], large['cyclic'],
                rescue['cyclic']]
    return sum(reading['launches'] for reading in streamed), tiles


def trained_variant(torch, folder, dtype, on=None):
    """The raw variant parameters stored under a trained model's folder, read
    from its CSVs (the large route writes (L, M) lengthscales for an
    isotropic model too, which an isotropic reload refuses), at `dtype`."""
    from romcomma_tpu_torch.base.classes import Frame
    from romcomma_tpu_torch.models import params
    variance, ls, noise = (Frame(folder / csv).np for csv in (
        'kernel/variance', 'kernel/lengthscales', 'likelihood/variance'))
    return {n: t.to(dtype) for n, t in params.variant_init(variance[0], ls, noise[0],
                                                           on=on or CARD).items()}


def large_route_phase(torch, user, gram_kernels):
    """Phase 8b: run.gpr at N=LARGE_N, whose improper fold takes the large
    route; every fold's LML against the float64 plain LML, and the improper
    fold's log_marginal.csv against the optimizer's own LML."""
    import numpy as np
    import pandas as pd
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models import gp, params
    root = ROOT / 'build' / 'chip_smoke_large'
    shutil.rmtree(root, ignore_errors=True)
    np_seed(SEED)
    noise = user.sample.GaussianNoise.Variance(L=len(user.functions.OAKLEY2004), magnitude=0.04)
    repo = user.sample.Function(root, user.sample.DOE.latin_hypercube, user.functions.OAKLEY2004,
                                N=LARGE_N, M=M, noise_variance=noise, overwrite_existing=True,
                                seed=SEED).repo.into_K_folds(LARGE_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gram_kernels.LAUNCHES = gram_kernels.BATCHED_LAUNCHES = 0
    with calibration_records(torch, gram_kernels) as records, \
            distributed_records(torch) as calls:
        t0 = time.perf_counter()
        names = user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=None,
                             maxiter=LARGE_MAXITER)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = gram_kernels.LAUNCHES
    MAIN_PATH['large_batched_launches'] = gram_kernels.BATCHED_LAUNCHES
    print_calibration_records([r for r in records if r['step'] == 'fold-batched'])
    print(f'run.gpr N={LARGE_N}: {seconds:.2f} s, models {names}, folds {list(repo.folds)}, '
          f'unit-gram kernel launches {launches} ({gram_kernels.BATCHED_LAUNCHES} batched), '
          f'peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; DistributedGP calls '
          f'{[(c["N"], c["method"], str(c["dtype"]), c["iterations"]) for c in calls]}', flush=True)
    require(names == ['gpr.v.i', 'gpr.v.a'], names)
    require(len(calls) == len(names) and all(
        c['N'] == LARGE_N and c['method'] == 'calibrate_multi' for c in calls),
        f'the improper fold did not take the joint large route once per model: {calls}')
    worst = 0.0
    for k in repo.folds:
        fold = Fold(repo, k)
        X, Y = fold_tensors(torch, fold, torch.float32)
        for name, call in zip(names, calls if k == LARGE_K else [None] * len(names)):
            folder = fold.folder / name
            mine = {r['step']: r for r in records if r['k'] == k and r['name'] == name}
            require((folder / 'test.csv').is_file() and (folder / 'test_summary.csv').is_file(),
                    f'{folder} has no test.csv or test_summary.csv')
            raw = trained_variant(torch, folder, torch.float32)
            with torch.no_grad():
                lml32 = gp.lml_variant(raw, X, Y).double()
                raw64 = {n: t.double() for n, t in raw.items()}
                lml64 = gp.lml_variant(raw64, X.double(), Y.double())
                c = params.variant_constrain(raw64)
            stored = pd.read_csv(folder / 'likelihood' / 'log_marginal.csv',
                                 index_col=0).to_numpy()[0]
            checked = [lml32] + ([torch.tensor(stored, dtype=torch.float64, device=CARD)]
                                 if call is not None else [])
            # Phase 4's first-order bound of a float32 LML.
            bound = 10 * fold.N * 1.1920929e-07 * (c['variance'] / c['noise'] + 1.0)
            errors = [(value - lml64).abs() for value in checked]
            worst = max([worst] + [(e / bound).max().item() for e in errors])
            print(f'fold.{k} {name} N={fold.N} ({"large" if call else "small"} route): calibrate '
                  f'{mine["calibrate"]["seconds"]:.2f} s ({mine["calibrate"]["launches"]} launches), '
                  f'test {mine["test"]["seconds"]:.2f} s; LML f64 plain {lml64.tolist()}, '
                  f'|f32 kernel - f64| {errors[0].tolist()}'
                  + (f', |stored (the optimizer\'s) - f64| {errors[1].tolist()}' if call else '')
                  + f'; bound {bound.tolist()}', flush=True)
            require(all(bool((e <= bound).all()) for e in errors), (k, name, errors, bound))
            if call is not None:
                require(np.allclose(stored, call['lml'], rtol=1e-15, atol=0),
                        (k, name, stored, call['lml']))
    gradient_worst = check_exact_lml(torch, gram_kernels, Fold(repo, LARGE_K), 'gpr.v.a')
    return launches, seconds, worst, gradient_worst


def check_exact_lml(torch, gram_kernels, fold, name):
    """Phase 8b, at the improper fold's N, on output 0 of a trained
    large-route model: one float32 ExactLML value+grad timed (mean of 3 after
    a warm-up); then ExactLML's value and its ls, s2 and noise gradients, in
    float32 (gram from the kernel) and in float64 (plain gram), each against
    autograd through the float64 Cholesky of the plainly built K, on the same
    parameters and inputs (``ExactReference``): the small route's LML and a
    fold group's, and phase 8e's reference for the large route's 'upper'.

    The limits are phase 7's, from the measured spectrum of the float64 K: a
    perturbation dK of norm eps lam_max moves the LML by at most
    1/2 ||dK|| (tr K^-1 + ||alpha||^2), and a gradient entry
    1/2 tr(W dK/dtheta), W = alpha alpha^T - K^-1, by at most
    1/2 ||dK/dtheta||_* ||dW|| with ||dW|| <= eps cond(K) (1/lam_min +
    2 ||alpha||^2). ||dK/ds2||_* = ||dK/dnoise||_* = N (both PSD, trace N);
    ||dK/dls_m||_* <= sqrt(N) ||Knn o D_m||_F / ls_m^3, D_m the squared
    differences of input m, measured. FIRST_ORDER_MARGIN times each is the
    limit. Returns the largest error / limit."""
    from romcomma_tpu_torch.models import params
    from romcomma_tpu_torch.ops.gram import rbf_gram
    from romcomma_tpu_torch.ops.linalg import add_diag, cholesky, mvn_logpdf
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    X, Y = fold_tensors(torch, fold, torch.float32)
    N = fold.N
    with torch.no_grad():
        c = params.variant_constrain(trained_variant(torch, fold.folder / name, torch.float32))
    hypers = (c['lengthscales'][0], c['variance'][0], c['noise'][0])
    dgp = ExactReference(DistributedGP(N, dtype=torch.float32, engine='upper'))

    def step():
        p = [t.clone().requires_grad_(True) for t in hypers]
        torch.autograd.grad(dgp.lml(*p, X, Y[:, 0]), p)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    print(f'N={N}: one float32 value+grad (ExactLML) {(time.perf_counter() - t0) / 3 * 1e3:.2f} '
          f'ms wall (mean of 3)', flush=True)

    X64, y64 = X.double(), Y[:, 0].double()
    hypers64 = tuple(h.double() for h in hypers)

    def value_and_grads(lml, at):
        p = [t.detach().clone().requires_grad_(True) for t in at]
        value = lml(*p)
        return [value.detach().double()] + [g.double() for g in torch.autograd.grad(value, p)]

    def autograd_lml(ls, s2, noise):
        K = add_diag(rbf_gram(X64, X64, ls, s2), noise)
        return torch.sum(mvn_logpdf(y64[:, None], torch.zeros_like(y64)[:, None], cholesky(K)))

    launches = gram_kernels.LAUNCHES
    readings = {'float32': value_and_grads(lambda *p: dgp.lml(*p, X, Y[:, 0]), hypers)}
    require(gram_kernels.LAUNCHES == launches + 1, 'the float32 gram missed the kernel')
    dgp64 = ExactReference(DistributedGP(N, dtype=torch.float64, engine='upper'))
    readings['float64'] = value_and_grads(lambda *p: dgp64.lml(*p, X64, y64), hypers64)
    want = value_and_grads(autograd_lml, hypers64)
    ls64, s2_64, noise64 = hypers64
    with torch.no_grad():
        K = rbf_gram(X64, X64, ls64, s2_64)
        frobenius = []
        for m in range(X64.shape[1]):
            D = (X64[:, m, None] - X64[None, :, m]) ** 2
            frobenius.append(float(torch.linalg.norm(K * D)) / float(ls64[m]) ** 3)
            del D
        K.diagonal().add_(noise64)
        alpha2 = float(torch.sum(y64 * torch.cholesky_solve(y64[:, None],
                                                            torch.linalg.cholesky(K))[:, 0]))
        lam = torch.linalg.eigvalsh(K)
        del K
    lam_min, lam_max = float(lam[0]), float(lam[-1])
    tr_inv = float(torch.sum(1.0 / lam))
    cond = lam_max / lam_min if lam_min > 0 else math.inf
    nuclear = [math.sqrt(N) * f for f in frobenius]
    print(f'N={N} {name} output 0: float64 K has lam_min {lam_min:.4e}, lam_max {lam_max:.4e}, '
          f'cond {cond:.4e}, tr K^-1 {tr_inv:.4e}, ||alpha||^2 {alpha2:.4e}; '
          f'||dK/dls_m||_* bound from {min(nuclear):.3e} to {max(nuclear):.3e}', flush=True)
    worst, failures = 0.0, []
    for label, got in readings.items():
        eps = EPS[label]
        dW = eps * cond * (1 / lam_min + 2 * alpha2)
        limits = [FIRST_ORDER_MARGIN * 0.5 * eps * lam_max * (tr_inv + alpha2),
                  torch.tensor([FIRST_ORDER_MARGIN * 0.5 * n * dW for n in nuclear],
                               dtype=torch.float64, device=CARD),
                  FIRST_ORDER_MARGIN * 0.5 * N * dW, FIRST_ORDER_MARGIN * 0.5 * N * dW]
        errors = [(g - w).abs() for g, w in zip(got, want)]
        ratios = [float((e / limit).max()) for e, limit in zip(errors, limits)]
        worst = max(worst, *ratios)
        print(f'  ExactLML {label} against float64 autograd: LML {got[0].item():.6f} vs '
              f'{want[0].item():.6f}, |diff| {errors[0].item():.3e} (limit {limits[0]:.3e}); '
              + ', '.join(f'{key} max |diff| {float(e.max()):.3e} of max |{key}| '
                          f'{float(w.abs().max()):.3e} (error / limit {r:.3e})'
                          for key, e, w, r in zip(('dls', 'ds2', 'dnoise'), errors[1:], want[1:],
                                                  ratios[1:])), flush=True)
        if not all(math.isfinite(r) and r <= 1.0 for r in ratios):
            failures.append((label, [float(e.max()) for e in errors], ratios))
    require(not failures, failures)
    return worst


def distributed_tables(torch, inputs, on):
    """From float64 inputs (X, Y, Xs, (ls, s2, noise)), on `on`: DistributedGP's
    LML, its gradient, posterior alpha, predictions at Xs, and the first-order
    and total indices with non-partial standard errors. On the host."""
    import numpy as np
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    X, Y, Xs, hypers = inputs
    dgp = DistributedGP(len(X), mesh=on, dtype=np.float64, engine='upper')
    x, y = dgp.stage(X, Y)
    p = [torch.tensor(h, dtype=torch.float64, device=on, requires_grad=True) for h in hypers]
    value = dgp.lml(*p, x, y)
    tables = {'lml': value} | dict(zip(('d lml / d ls', 'd lml / d s2', 'd lml / d noise'),
                                       torch.autograd.grad(value, p)))
    tables['alpha'] = dgp.posterior_alpha(*hypers, x, y)[0]
    tables['mean'], tables['var'] = dgp.predict(*hypers, x, y, Xs)
    indices = dgp.sobol_indices(*hypers, x, y, X, kind=('first_order', 'total'), error=True,
                                is_T_partial=False)
    tables = {key: value.detach().cpu().numpy() for key, value in tables.items()}
    for key in ('S', 'T'):
        for kind, by_m in indices[key].items():
            tables[f'{kind} {key}'] = np.array([by_m[m] for m in sorted(by_m)])
    return tables


def distributed_card_against_cpu(torch):
    """Phase 8c: the card's DistributedGP against the CPU's at N=CARD_CPU_N,
    M=CARD_CPU_M, from the same float64 inputs: every table within
    CARD_CPU_TOL of its largest entry, T squared within ULP_SPREADS of its
    spread, the CPU's largest response to one-ulp moves of the
    hyperparameters (phase 6's rule)."""
    import numpy as np
    from romcomma_tpu_torch import north_star
    X, Y = north_star.problem(CARD_CPU_N, CARD_CPU_M)
    rng = np.random.default_rng(SEED)
    Xs = rng.standard_normal((256, CARD_CPU_M))
    hypers = (rng.uniform(1.5, 4.0, CARD_CPU_M), 1.0, 0.01)
    t0 = time.perf_counter()
    card = distributed_tables(torch, (X, Y, Xs, hypers), CARD)
    cpu = distributed_tables(torch, (X, Y, Xs, hypers), 'cpu')

    def nudged(draw):
        g = np.random.default_rng(1000 + draw)
        return tuple(np.nextafter(h, np.where(g.random(np.shape(h)) < 0.5, -np.inf, np.inf))
                     for h in hypers)

    moved = [distributed_tables(torch, (X, Y, Xs, nudged(d)), 'cpu') for d in range(ULP_DRAWS)]
    readings, failures = [], []
    for key, want in cpu.items():
        require(bool(np.isfinite(card[key]).all()), f'{key} is not finite on the card')
        apart = _table_distance(key, card[key], want)
        if key.endswith(' T'):
            ulps = max(_table_distance(key, m[key], want) for m in moved)
            ratio = apart / ulps if ulps else (math.inf if apart else 0.0)
            readings.append(f'{key} T^2 {apart:.2e} = {ratio:.3f} spreads of {ulps:.2e}')
            if ratio > ULP_SPREADS:
                failures.append((key, apart, ulps))
        else:
            readings.append(f'{key} {apart:.2e}')
            if apart > CARD_CPU_TOL:
                failures.append((key, apart))
    print(f'N={CARD_CPU_N} M={CARD_CPU_M}, float64, card against the CPU in '
          f'{time.perf_counter() - t0:.2f} s; worst |card - CPU| / max |CPU| (limit '
          f'{CARD_CPU_TOL}; T squared, limit {ULP_SPREADS} spreads): ' + ', '.join(readings),
          flush=True)
    require(not failures, failures)


#: Phase 9a/9b: romcomma_tpu_torch.rom_scale's repository (benchmarks/rom_scale.py's
#: N=8192, M=10 planted plane), float32 training, its ROM 'sobol' for 3 iterations
#: and 'active_subspace' for 2.
ROM_N, ROM_M, ROM_SOBOL_ITERATIONS, ROM_ACTIVE_ITERATIONS = 8192, 10, 3, 2
#: The largest principal angle between the planted plane and the learned leading
#: two rows of rotation.csv, and the least final leading index S[0:2]: the noise
#: (0.05^2 of a unit output variance) is outside the posterior mean that S reads.
ROM_ANGLE_DEG, ROM_S_M_MIN = 5.0, 0.98
#: Phase 9c: the card against the CPU on identical float64 inputs.
ROM_CARD_CPU_N, ROM_CARD_CPU_M, ROM_CARD_CPU_L = 512, 6, 3
ROM_CARD_CPU_TOL = 1e-10


def rom_run(torch, gram_kernels, iterations, method):
    """One rom_scale run on the card, its unit-gram launches counted from 0,
    checked: the planted plane recovered, rotation.csv orthonormal with det
    +1, meta.json's history persisted. Returns (record, launches)."""
    from romcomma_tpu_torch import rom_scale
    torch.cuda.synchronize()
    gram_kernels.LAUNCHES = 0
    out, state = rom_scale.run(ROM_N, ROM_M, iterations, method,
                               root=ROOT / 'build' / f'chip_smoke_rom_{method}')
    launches = gram_kernels.LAUNCHES
    print(json.dumps(out), flush=True)
    history = json.loads((state['rom'].folder / 'meta.json').read_text())['history']
    print(f'ROM {method}: {out["iterations_run"]} iterations in {out["rom_s"]:.2f} s '
          f'(stages, s: {json.dumps(out["stage_seconds"])}); S[0:2] history '
          f'{out["S_m_history"]}; principal angles to the planted plane '
          f'{out["principal_angles_deg"]} deg (limit {ROM_ANGLE_DEG}); rotation.csv '
          f'|R R^T - I| {out["rotation_orthonormality"]:.2e}, det {out["rotation_det"]:.12f}; '
          f'S_rotated value+grad {out["S_rotated_evaluations"]} in the descents at '
          f'{out["S_rotated_ms_in_descent"]} ms each (scipy included), alone '
          f'{out["S_rotated_valgrad_ms"]:.3f} ms; predict_gradient of 256 points '
          f'{out["predict_gradient_256_ms"]:.3f} ms; one {out["dtype"]} LML value+grad '
          f'{out["lml_valgrad_ms"]:.3f} ms; unit-gram launches {launches}; peak device '
          f'memory {out["peak_gib"]:.2f} GiB', flush=True)
    require(launches > 0, f'ROM {method} never launched the unit-gram kernel')
    require(out['dtype'] == 'float32', out['dtype'])
    require(max(out['principal_angles_deg']) <= ROM_ANGLE_DEG, out['principal_angles_deg'])
    require(out['rotation_orthonormality'] <= 1e-8 and abs(out['rotation_det'] - 1) <= 1e-8,
            (out['rotation_orthonormality'], out['rotation_det']))
    require(len(history) > 0 and history == state['meta']['history'], history)
    return out, launches


def rom_tables(torch, tree, raws, on, P, A):
    """From the models in `tree` with the float64 raw parameters `raws`, on
    `on`: predict_gradient's mean and covariance of the variant and the
    covariant model (F non-diagonal) at 64 points, V_rotated(P) of the
    variant model, the gradient in the Cayley parameters A of
    optimize_theta's objective (Mu = 2), and _cayley(A). On the host."""
    import numpy as np
    from romcomma_tpu_torch.base.definitions import pinned_device
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.gsa.calibrators import ClosedSobolWithRotation
    from romcomma_tpu_torch.models.gpr import MOGP
    on = torch.device(on)
    xs = np.random.default_rng(SEED).standard_normal((64, ROM_CARD_CPU_M))
    tables = {}
    with pinned_device(on):
        fold = Fold(Repository(tree), 0)
        for name, covariant in (('gpr.v.a', False), ('gpr.c.a', True)):
            gp = MOGP(name, fold, True, covariant, False)
            # The raw parameters come from the caller in float64: made on each
            # device in float32 they can round one ulp apart (PERF.md section 7).
            gp._raw = lambda raw=raws[name]: {k: v.to(on) for k, v in raw.items()}
            kind = 'covariant' if covariant else 'variant'
            tables[f'{kind} gradient mean'], tables[f'{kind} gradient covariance'] = (
                gp.predict_gradient(xs))
            if not covariant:
                cal = ClosedSobolWithRotation(gp)
                tables['V_rotated'] = cal.V_rotated(torch.as_tensor(P, device=on))
                a = torch.tensor(A, device=on, requires_grad=True)
                value = -torch.mean(torch.diagonal(cal.S_rotated(cal._cayley(a, ROM_CARD_CPU_M)[:2])))
                tables['d objective / d A'] = torch.autograd.grad(value, a)[0]
                tables['_cayley'] = cal._cayley(torch.as_tensor(A, device=on), ROM_CARD_CPU_M)
    return {key: value.detach().cpu().numpy() if torch.is_tensor(value) else value
            for key, value in tables.items()}


def rom_card_against_cpu(torch):
    """Phase 9c: at N=ROM_CARD_CPU_N, M=ROM_CARD_CPU_M, L=ROM_CARD_CPU_L, the
    card's rom_tables against the CPU's from identical float64 inputs, each
    within ROM_CARD_CPU_TOL of its largest entry or, where it is not, within
    ULP_SPREADS of the CPU's largest response to one-ulp moves of the raw
    parameters (phase 6's rule)."""
    import numpy as np
    import pandas as pd
    from romcomma_tpu_torch.base.definitions import pinned_device
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.models.gpr import MOGP
    N_, M_, L_ = ROM_CARD_CPU_N, ROM_CARD_CPU_M, ROM_CARD_CPU_L
    root = ROOT / 'build' / 'chip_smoke_rom_card_cpu'
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    X = rng.uniform(size=(N_, M_))
    z = X - 0.5
    Y = np.stack([np.sin(3 * z[:, 0] + z[:, 1]), z[:, 2] ** 2 - z[:, 3], z @ rng.normal(size=M_)],
                 axis=1) + 0.05 * rng.standard_normal((N_, L_))
    columns = pd.MultiIndex.from_tuples([('X', f'X.{i}') for i in range(M_)]
                                        + [('Y', f'Y.{l}') for l in range(L_)])
    tree = root / 'repo'
    with pinned_device(torch.device('cpu')):
        fold = Fold(Repository.from_df(tree, pd.DataFrame(np.column_stack([X, Y]),
                                                          columns=columns)).into_K_folds(-1), 0)
        G = rng.normal(size=(L_, L_))
        F = 0.3 * G @ G.T + np.diag(rng.uniform(0.5, 1.5, L_))
        for name, covariant, variance, noise in (
                ('gpr.v.a', False, rng.uniform(0.7, 1.3, (1, L_)), np.array([[0.02, 0.03, 0.05]])),
                ('gpr.c.a', True, F, np.diag([0.02, 0.03, 0.05]))):
            gp = MOGP(name, fold, False, covariant, False)
            gp.kernel.data.replace(variance=variance, lengthscales=rng.uniform(0.8, 2.5, (L_, M_)))
            gp.likelihood.data.replace(variance=noise)
        raws = {name: {k: v.double() for k, v in MOGP(name, fold, True, name == 'gpr.c.a',
                                                        False)._raw().items()}
                for name in ('gpr.v.a', 'gpr.c.a')}
    Q, _ = np.linalg.qr(rng.standard_normal((M_, M_)))
    P, A = Q[:2], rng.normal(scale=0.5, size=M_ * (M_ - 1) // 2)
    t0 = time.perf_counter()
    card = rom_tables(torch, tree, raws, CARD, P, A)
    cpu = rom_tables(torch, tree, raws, 'cpu', P, A)

    def nudged(draw):
        g = np.random.default_rng(1000 + draw)
        return {name: {k: torch.from_numpy(np.nextafter(v.numpy(), np.where(
            g.random(tuple(v.shape)) < 0.5, -np.inf, np.inf))) for k, v in raw.items()}
            for name, raw in raws.items()}

    moved = None

    def distance(got, want):
        return float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)

    readings, failures = [], []
    for key, want in cpu.items():
        require(bool(np.isfinite(card[key]).all()), f'{key} is not finite on the card')
        apart = distance(card[key], want)
        if apart <= ROM_CARD_CPU_TOL:
            readings.append(f'{key} {apart:.2e}')
            continue
        if moved is None:
            moved = [rom_tables(torch, tree, nudged(d), 'cpu', P, A) for d in range(ULP_DRAWS)]
        ulps = max(distance(m[key], want) for m in moved)
        ratio = apart / ulps if ulps else (math.inf if apart else 0.0)
        readings.append(f'{key} {apart:.2e} = {ratio:.3f} spreads of {ulps:.2e}')
        if ratio > ULP_SPREADS:
            failures.append((key, apart, ulps))
    print(f'N={N_} M={M_} L={L_}, float64, card against the CPU in '
          f'{time.perf_counter() - t0:.2f} s; worst |card - CPU| / max |CPU| (limit '
          f'{ROM_CARD_CPU_TOL}, else {ULP_SPREADS} spreads of one-ulp moves of the raw '
          f'parameters): ' + ', '.join(readings), flush=True)
    require(not failures, failures)


def _iterations(folder) -> list:
    """The iteration counts of meta.json's result ("Converged in [...]")."""
    result = json.loads((folder / 'meta.json').read_text())['result']
    return json.loads(result[len('Converged in '):result.index(']') + 1])


def sequential_phase(torch, user, gram_kernels, repo):
    """Phase 10: run.gpr and run.gsa with fold_parallel=False on phase 4's
    sampled copy, beside phases 4 and 6's batched runs; each fold and
    output's LML against the batched one's within phase 4's first-order
    bound, iterations side by side; then, from phase 4's trained
    parameters, each batched fold's stacked GSA (phase 6) against its
    per-fold GSA, within ULP_SPREADS of a one-ulp-of-K^-1 y spread taken on
    the card (the CPU's would take minutes per draw at N=4096)."""
    import numpy as np
    import pandas as pd
    from romcomma_tpu_torch.data.storage import Fold, Repository
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.models import params
    from romcomma_tpu_torch.models.gpr import MOGP
    sequential = Repository(SEQUENTIAL_ROOT)
    gram_kernels.LAUNCHES = 0
    with calibration_records(torch, gram_kernels) as records:
        t0 = time.perf_counter()
        names = user.run.gpr('gpr', sequential, is_read=False, is_covariant=False,
                             is_isotropic=None, maxiter=MAXITER, fold_parallel=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = gram_kernels.LAUNCHES
    require(names == ['gpr.v.i', 'gpr.v.a'] and not any(r['step'] == 'fold-batched'
                                                        for r in records), names)
    print(f'run.gpr fold_parallel=False: {seconds:.2f} s, {launches} unit-gram launches; '
          f'batched (phase 4): {MAIN_PATH["gpr_seconds"]:.2f} s, {MAIN_PATH["gpr_launches"]} '
          f'launches', flush=True)
    worst = 0.0
    for k in repo.folds:
        for name in names:
            folders = [Fold(r, k).folder / name for r in (repo, sequential)]
            lml = [pd.read_csv(f / 'likelihood' / 'log_marginal.csv', index_col=0).to_numpy()[0]
                   for f in folders]
            model = MOGP(name, Fold(repo, k), is_read=True, is_covariant=False,
                         is_isotropic=name.endswith('.i'))
            with torch.no_grad():
                c = params.variant_constrain({n: t.double() for n, t in model._variant_raw().items()})
            bound = (10 * model.N * 1.1920929e-07 * (c['variance'] / c['noise'] + 1.0)).cpu().numpy()
            error = np.abs(lml[0] - lml[1])
            worst = max(worst, float((error / bound).max()))
            print(f'fold.{k} {name} N={model.N}: LML batched {lml[0].tolist()} sequential '
                  f'{lml[1].tolist()}, |diff| {error.tolist()} bound {bound.tolist()}; iterations '
                  f'batched {_iterations(folders[0])} sequential {_iterations(folders[1])}',
                  flush=True)
            require(bool((error <= bound).all()), (k, name, error, bound))
    t0 = time.perf_counter()
    user.run.gsa('gpr', sequential, kinds=user.run.GSA.ALL_KINDS, fold_parallel=False,
                 **GSA_OPTIONS)
    torch.cuda.synchronize()
    gsa_seconds = time.perf_counter() - t0
    check_gsa_tree(sequential)
    stacked = MAIN_PATH['stacked_gsa']
    print(f'run.gsa fold_parallel=False: {gsa_seconds:.2f} s; batched (phase 6): '
          f'{MAIN_PATH["gsa_seconds"]:.2f} s; kernel launches (phase 6\'s profiles): '
          + ', '.join(f'{label} {launch_count}' for label, (_, launch_count) in stacked.items()),
          flush=True)
    readings = []
    for k, record in zip(range(K), MAIN_PATH['gsa_records']):
        gp = MOGP('gpr.v.a', Fold(repo, k), is_read=True, is_covariant=False, is_isotropic=False)
        inputs = calibrators.ClosedSobol.gather_arrays(gp)
        shape = {'L': gp.L, 'M': gp.M, 'N': gp.N}
        t0 = time.perf_counter()
        per_fold, _ = gsa_of(inputs, shape)
        per_fold_s = time.perf_counter() - t0
        ulps = spread(per_fold, lambda d: gsa_of(inputs | {'K_inv_Y': inputs['K_inv_Y'] * (
            1 + 2.0 ** -52 * _signs(torch, inputs['K_inv_Y'].shape, 100 * k + d).to(
                inputs['K_inv_Y'].device))}, shape)[0])
        within_spreads(f'fold {k} N={gp.N}: the stacked GSA (phase 6) against the per-fold GSA '
                       f'({per_fold_s:.2f} s) from the same parameters, one-ulp-of-K^-1 y spread',
                       _table_errors(record['results'], per_fold), ulps, readings)
    print(f'stacked against per-fold GSA: largest distance {max(readings):.3f} spreads (limit '
          f'{ULP_SPREADS}); LML: worst |batched - sequential| / bound {worst:.3e}', flush=True)
    require(max(readings) <= ULP_SPREADS, 'the stacked GSA and the per-fold GSA differ')


@contextmanager
def entry_records(torch):
    """Wall-clock and peak device memory of each run.gpr and run.gsa call that
    a CLI makes (the card synchronised at both ends; calls that these make
    count in theirs), and every warning raised meanwhile: run's automatic
    fold-parallel mode warns where it falls back to the per-fold loop."""
    import warnings
    from romcomma_tpu_torch.user import run
    calls, depth = [], [0]
    originals = {'gpr': run.gpr, 'gsa': run.gsa}

    def timed(step, function):
        def wrapper(*args, **kwargs):
            depth[0] += 1
            try:
                if depth[0] > 1:
                    return function(*args, **kwargs)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = function(*args, **kwargs)
                torch.cuda.synchronize()
                calls.append({'step': step, 'seconds': time.perf_counter() - t0,
                              'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30})
                return out
            finally:
                depth[0] -= 1
        return wrapper

    for step, function in originals.items():
        setattr(run, step, timed(step, function))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            yield {'calls': calls, 'warnings': caught}
    finally:
        for step, function in originals.items():
            setattr(run, step, function)


@contextmanager
def round_records(torch):
    """Each round of lbfgs.minimize_lockstep: its live descents and the
    seconds from the call of its objective to its gradients (the batch's
    value+grad, the card synchronised at both ends). The rest of a fold
    group's time is the host's: scipy in its threads, and the hand-over."""
    from romcomma_tpu_torch.ops import lbfgs
    rounds, state = [], {'t0': None}
    lockstep, flat_grad = lbfgs.minimize_lockstep, lbfgs._Packing.flat_grad

    def timed_lockstep(fun, starts, *args, **kwargs):
        def timed_fun(members, p):
            torch.cuda.synchronize()
            state['t0'], state['members'] = time.perf_counter(), len(members)
            return fun(members, p)
        return lockstep(timed_fun, starts, *args, **kwargs)

    def timed_flat_grad(self, grads, n):
        if state['t0'] is not None:
            torch.cuda.synchronize()
            rounds.append((state['members'], time.perf_counter() - state['t0']))
            state['t0'] = None
        return flat_grad(self, grads, n)

    lbfgs.minimize_lockstep, lbfgs._Packing.flat_grad = timed_lockstep, timed_flat_grad
    try:
        yield rounds
    finally:
        lbfgs.minimize_lockstep, lbfgs._Packing.flat_grad = lockstep, flat_grad


def drive_cli(torch, gram_kernels, label, call):
    """Run a CLI, call(), with the unit-gram launches counted from 0 and its
    run.gpr and run.gsa, calibrations, lockstep rounds and GSA recorded;
    require one run.gpr, one run.gsa, no fallback to the per-fold loop and a
    launch; print the wall-clock split. Returns (records, rounds, GSA
    records, launches, batched launches, seconds)."""
    gram_kernels.LAUNCHES = gram_kernels.BATCHED_LAUNCHES = 0
    with (entry_records(torch) as entries, calibration_records(torch, gram_kernels) as records,
          round_records(torch) as rounds, gsa_records(torch) as gsas):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches, batched = gram_kernels.LAUNCHES, gram_kernels.BATCHED_LAUNCHES
    fallbacks = [str(w.message) for w in entries['warnings'] if 'fold-parallel' in str(w.message)]
    require(not fallbacks, (label, fallbacks))
    steps = {entry['step']: entry for entry in entries['calls']}
    require(sorted(steps) == ['gpr', 'gsa'] and len(entries['calls']) == 2,
            (label, entries['calls']))
    print(f'{label}: {seconds:.2f} s (run.gpr {steps["gpr"]["seconds"]:.2f} s, peak '
          f'{steps["gpr"]["peak_gib"]:.2f} GiB; run.gsa {steps["gsa"]["seconds"]:.2f} s, peak '
          f'{steps["gsa"]["peak_gib"]:.2f} GiB); unit-gram launches {launches}, of them batched '
          f'{batched}', flush=True)
    require(launches > 0, f'{label} never launched the unit-gram kernel')
    return records, rounds, gsas, launches, batched, seconds


def check_csvs_finite(folder) -> int:
    """Every CSV under folder has a row besides its header, and every number
    in it is finite. Returns the count of CSVs."""
    import numpy as np
    import pandas as pd
    count = 0
    for path in sorted(Path(folder).rglob('*.csv')):
        cells = pd.read_csv(path, header=None, dtype=str, keep_default_na=False).to_numpy().ravel()
        numbers = []
        for cell in cells:
            try:
                numbers.append(float(cell))
            except ValueError:
                pass
        require(len(cells) > 1 and numbers and bool(np.isfinite(numbers).all()),
                f'{path}: empty, or a number that is not finite')
        count += 1
    return count


def group_summary(records, rounds, size, label):
    """Print the one fold group of `size` descents that run.gpr trained in
    lockstep, each round one launch (batched while two descents or more are
    live), its rounds' value+grad time against the host's, and the folds
    calibrated alone and the test()s."""
    from collections import Counter
    groups = [r for r in records if r['step'] == 'fold-batched']
    require(len(groups) == 1 and groups[0]['size'] == size and groups[0]['batched'] > 0,
            (label, 'no fold group of', size, 'through batched launches', groups))
    group = groups[0]
    require(len(rounds) == group['launches'],
            ('a round is not one launch', len(rounds), group['launches']))
    iterations = [i for fold in group['iterations'] for i in fold]
    stops = Counter(stop for fold in group['stops'] for stop in fold)
    print(f'{label}: fold group of {group["folds"]} folds, {group["size"]} descents in lockstep: '
          f'{group["seconds"]:.2f} s, {len(rounds)} rounds (one launch each, '
          f'{group["batched"]} of them batched), {1e3 * group["seconds"] / len(rounds):.1f} ms a '
          f'round; iterations min / median / max {min(iterations)} / '
          f'{statistics.median(iterations)} / {max(iterations)}; scipy stops {dict(stops)}',
          flush=True)
    members = [n for n, _ in rounds]
    value_and_grad = sum(seconds for _, seconds in rounds)
    host = group['seconds'] - value_and_grad
    full = [1e3 * seconds for n, seconds in rounds if n == size] or [0.0]
    print(f'  {len(rounds)} rounds of {min(members)}-{max(members)} live descents (mean '
          f'{statistics.mean(members):.1f}; a round of all {size} {statistics.median(full):.1f} ms, '
          f'median): value+grad {value_and_grad:.2f} s in all, so the host\'s share of the group '
          f'{host:.2f} s, {1e3 * host / len(rounds):.1f} ms a round', flush=True)
    for r in records:
        if r['step'] == 'calibrate' and 'group' not in r:
            print(f'  fold.{r["k"]} {r["name"]} calibrated alone: {r["seconds"]:.2f} s, '
                  f'{r["launches"]} launches', flush=True)
    tests = [r for r in records if r['step'] == 'test']
    print(f'  test() of {len(tests)} folds: {sum(r["seconds"] for r in tests):.2f} s, '
          f'{sum(r["launches"] for r in tests)} launches', flush=True)


def likelihood_card_against_cpu(torch, repo, name='gpr.v.a'):
    """regression.gls and MOGaussian (predict_log_density and
    variational_expectations over the dense (L*n, L*n) latent covariance, the
    quadrature predict_log_density per point) on fold 0's test predictions,
    float64, on the card against the CPU, within LIKELIHOOD_TOL of each
    result's largest entry. The latent variance is the predictive one less the
    trained noise; gls fits the first output linearly in OAKLEY2004's active
    inputs, weighted by its predictive variance."""
    import numpy as np
    import pandas as pd
    from romcomma_tpu_torch.data.storage import Fold
    from romcomma_tpu_torch.models.gpr import MOGP
    from romcomma_tpu_torch.user import regression
    fold = Fold(repo, 0)
    test = pd.read_csv(fold.folder / name / 'test.csv', header=[0, 1], index_col=0)
    X, Y, mean, sd = (test[h].to_numpy(dtype=float) for h in ('X', 'Y', 'Mean', 'SD'))
    likelihood = MOGP(name, fold, is_read=True, is_covariant=False, is_isotropic=False).likelihood
    fvar = np.clip(sd ** 2 - likelihood.data.variance.np[0], 1e-12, None)
    latent = dict(Fmu=mean.T.reshape(-1), Fvar=np.diag(fvar.T.reshape(-1)), Y=Y.T.reshape(-1))
    results = {}
    for on in (CARD, 'cpu'):
        device = torch.device(on)
        mo = likelihood.mo_gaussian(dtype=torch.float64, on=device)
        beta, cov_beta = regression.gls(X[:, :ACTIVE_INPUTS], Y[:, :1], np.diag(sd[:, 0] ** 2),
                                        on=device)
        results[on] = {'predict_log_density': mo.predict_log_density(**latent),
                       'variational_expectations': mo.variational_expectations(**latent),
                       'quad_predict_log_density': mo.quad_predict_log_density(mean, fvar, Y),
                       'gls beta': beta, 'gls covariance': cov_beta}
    worst = 0.0
    for key, want in results['cpu'].items():
        got = results[CARD][key]
        require(got.device.type == CARD and got.dtype == torch.float64, key)
        error = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        require(math.isfinite(error), (key, got, want))
        worst = max(worst, error)
        print(f'  {key}: card against CPU {error:.3e} of its largest entry (tol {LIKELIHOOD_TOL})',
              flush=True)
    require(worst <= LIKELIHOOD_TOL, ('likelihood and gls, card against CPU', worst))
    print(f'likelihood layer and gls on fold 0\'s {len(Y)} test predictions (L*n = {Y.size}): '
          f'worst {worst:.3e}', flush=True)
    return worst


def csv_phase(torch, user, gram_kernels):
    """Phase 11: csv_script's workflow through its CLI (-r -a, the defaults),
    on a user CSV of N=CSV_N rows; each fold and output's LML within phase 4's
    first-order bound, the GSA tree and every CSV finite; the fold group's
    rounds, their value+grad and host time, peak memory; the stacked GSA of
    the 20 folds against run.gsa's per-fold loop on a copy; the likelihood
    layer and gls card against CPU. Returns (launches, batched launches,
    seconds)."""
    import numpy as np
    import pandas as pd
    from romcomma_tpu_torch import csv_script
    from romcomma_tpu_torch.data.storage import Repository
    shutil.rmtree(CSV_ROOT, ignore_errors=True)
    np_seed(SEED)
    noise = user.sample.GaussianNoise.Variance(L=len(user.functions.OAKLEY2004), magnitude=0.04)
    sampled = user.sample.Function(CSV_ROOT / 'sampled', user.sample.DOE.latin_hypercube,
                                   user.functions.OAKLEY2004, N=CSV_N, M=CSV_M,
                                   noise_variance=noise, overwrite_existing=True, seed=SEED).repo
    csv, root = CSV_ROOT / 'oakley2004.csv', CSV_ROOT / 'root'
    shutil.copyfile(sampled.folder / 'data.csv', csv)        # a user's CSV, X and Y columns
    require(csv_script.K == CSV_K, csv_script.K)
    random.seed(SEED)                                        # the fold assignment
    records, rounds, gsas, launches, batched, seconds = drive_cli(
        torch, gram_kernels, 'csv_script -r -a',
        lambda: csv_script.main(['-r', '-a', str(csv), str(root)]))
    repo = Repository(root)
    require(list(repo.folds) == list(range(CSV_K + 1)), list(repo.folds))
    group_summary(records, rounds, CSV_K * 3, 'run.gpr')
    worst = check_lml_bounds(torch, repo, ['gpr.v.a'], echo=False)
    print(f'LML of {len(repo.folds)} folds x 3 outputs: worst |f32 kernel - f64 plain| / bound '
          f'{worst:.3e}', flush=True)
    print_gsa_records(gsas)
    groups = [r['group'] for r in gsas]
    require(groups == [CSV_K] * CSV_K + [1],
            f'the {CSV_K} equal folds did not run as one stacked pass: {groups}')
    check_gsa_tree(repo, M_=CSV_M)
    print(f'{check_csvs_finite(root)} CSVs written and finite under the CLI\'s root', flush=True)
    likelihood_card_against_cpu(torch, repo)
    # The per-fold loop on a copy of the trained tree, against the stacked pass.
    per_fold_root = CSV_ROOT / 'per_fold'
    shutil.copytree(root, per_fold_root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    user.run.gsa('gpr', Repository(per_fold_root), kinds=user.run.GSA.ALL_KINDS,
                 fold_parallel=False, **GSA_OPTIONS)
    torch.cuda.synchronize()
    per_fold_s = time.perf_counter() - t0
    apart = 0.0
    for k in range(CSV_K):
        for kind in KINDS:
            for csv_name in 'SV':
                path = Path(f'fold.{k}') / 'gpr.v.a' / 'gsa' / kind / f'{csv_name}.csv'
                a, b = (pd.read_csv(r / path, index_col=[0, 1]).to_numpy()
                        for r in (root, per_fold_root))
                apart = max(apart, float(np.abs(a - b).max() / np.abs(b).max()))
    stacked_s, improper_s = gsas[0]['seconds'], gsas[-1]['seconds']
    faster = 'stacked' if stacked_s < per_fold_s - improper_s else 'per-fold'
    print(f'GSA of the {CSV_K} proper folds: one stacked pass {stacked_s:.2f} s against '
          f'run.gsa\'s per-fold loop (fold_parallel=False, all {CSV_K + 1} folds) '
          f'{per_fold_s:.2f} s, of which the improper fold ~{improper_s:.2f} s; so the per-fold '
          f'loop of the {CSV_K} ~{per_fold_s - improper_s:.2f} s; {faster} is the faster; S and V '
          f'of the two within {apart:.3e} of their largest entry (6 decimals written)', flush=True)
    return launches, batched, seconds


def sweep_phase(torch, user, gram_kernels):
    """Phase 12: benchmark_script's sweep cell 325 through its CLI's own
    selection (-f -r -s -M 19 of 940 processes): ALL (L=9), N=8000, K=-2; each
    fold and output's LML within phase 4's first-order bound, the GSA tree and
    every CSV finite. The CLI's Latin hypercube takes its draw from SEED, as
    the noise and the folds do, so the cell is the same in every run. Returns
    (launches, batched launches, seconds)."""
    from romcomma_tpu_torch import benchmark_script
    from romcomma_tpu_torch.data.storage import Repository
    shutil.rmtree(SWEEP_ROOT, ignore_errors=True)
    design = benchmark_script.DOE

    def latin_hypercube(N_, M_, **kwargs):
        return design(N_, M_, seed=SEED, **kwargs)

    np_seed(SEED)                                            # the noise and the folds
    benchmark_script.DOE = latin_hypercube
    try:
        records, rounds, gsas, launches, batched, seconds = drive_cli(
            torch, gram_kernels, f'benchmark_script {" ".join(SWEEP_ARGV)}',
            lambda: benchmark_script.main(SWEEP_ARGV + [str(SWEEP_ROOT)]))
    finally:
        benchmark_script.DOE = design
    repo = Repository(SWEEP_ROOT / SWEEP_FOLDER)
    require(list(repo.folds) == [0, 1] and repo.L == SWEEP_L and repo.M == SWEEP_M,
            (list(repo.folds), repo.L, repo.M))
    group_summary(records, rounds, 2 * SWEEP_L, 'run.gpr')
    worst = check_lml_bounds(torch, repo, ['gpr.v.a'], echo=False)
    print(f'LML of 2 folds x {SWEEP_L} outputs: worst |f32 kernel - f64 plain| / bound '
          f'{worst:.3e}', flush=True)
    print_gsa_records(gsas)
    require([r['group'] for r in gsas] == [2, 2], [r['group'] for r in gsas])
    check_gsa_tree(repo, M_=SWEEP_M, L_=SWEEP_L)
    print(f'{check_csvs_finite(SWEEP_ROOT)} CSVs written and finite under the CLI\'s root',
          flush=True)
    return launches, batched, seconds


# --------------------------------------------------------------------------- #
# Phase 13: the multi-device variant route over an NCCL group
# --------------------------------------------------------------------------- #

#: The mesh engines, each at the north star's problem (N=20000, M=30,
#: float32) at NORTH_STAR_UPPER_OPTIMUM.
MESH_ENGINES = ('cyclic', 'cyclic2')
#: Value+grads and factorizations timed per engine (the median is reported),
#: and the iterations of each engine's calibrate.
MESH_TIMED, MESH_MAXITER = 5, 5
#: The kernel's shapes on the mesh path of one rank (Npad = 20224 for
#: B=256): the strips of the float64 gram (TILE_STRIP_ROWS rows against all,
#: two operands), the ring's one tile, the padded rows against themselves
#: (the gram 'cyclic''s backward rebuilds in float32), and the pair tiles of
#: 'cyclic2' (q B = 3584 rows, two operands).
MESH_TILE_SHAPES = ((4096, 20224, 30, False), (20224, 20224, 30, True),
                    (3584, 3584, 30, False))
#: Ranks of phase 13b, where the machine has several cards.
MESH_RANKS = 4
#: The north star's own start (ls 2, s2 1, noise 0.05), where phase 8a's
#: descents and each engine's calibrate begin. There each engine's float32
#: LML is held to ExactLML float32's within phase 4's bound (s2/noise = 20);
#: every other check of phase 13 is made at NORTH_STAR_UPPER_OPTIMUM
#: (s2/noise ~ 1.5e3), where that bound does not hold for ExactLML itself
#: (its float32 LML lies 61 from float64 there).
MESH_START = (2.0, 1.0, 0.05)
MESH_KINDS = ('first_order', 'total')
#: The parts of an LML evaluation that phase 13 holds apart: the value, dls
#: (its largest entry), ds2 and dnoise.
MESH_PARTS = ('LML', 'dls', 'ds2', 'dnoise')
#: Each engine's float32 LML evaluation on one rank (13a) against float64
#: ExactLML at NORTH_STAR_UPPER_OPTIMUM, part by part: within these
#: multiples of ExactLML float32's own distance from float64 ExactLML there.
#: One rank factorizes its float32 gram in float64 (MeshLML): about three
#: times the H100's readings there, at most 0.0042, 0.0092, 0.126 and
#: 0.0044 (PERF.md), so that a return to float32 factoring (read at 1.18,
#: 1.08, 36.9, 0.95 times) fails.
MESH_F32_MULTIPLES = (0.015, 0.03, 0.4, 0.015)
#: The same over several ranks (13b), which keep romcomma_tpu's float32
#: arithmetic: the limits set from one rank's readings in float32 (1.18,
#: 1.08, 36.9, 0.95; PERF.md); their float32 ds2 is the least accurate, since
#: K^-1, formed blockwise, carries more rounding than cholesky_inverse's
#: into sum(Bbar o Knn).
MESH_RANKS_F32_MULTIPLES = (4.0, 4.0, 100.0, 4.0)
#: Each engine's float64 LML evaluation against float64 ExactLML at the
#: optimum: within this share of ExactLML float32's distance, part by part
#: (float64 rounds 2^-29 ~ 1.9e-9 as finely as float32; read: <= 2.5e-9).
MESH_F64_SHARE = 1e-6


@contextmanager
def nccl_group(torch):
    """This process alone as a process group over NCCL on card 0 (world
    size 1), initialized from a file under build/; destroyed on exit."""
    import datetime
    import tempfile
    import torch.distributed as dist
    torch.cuda.set_device(0)
    (ROOT / 'build').mkdir(exist_ok=True)
    folder = Path(tempfile.mkdtemp(dir=ROOT / 'build'))
    dist.init_process_group('nccl', init_method=f'file://{folder / "group"}', rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(folder, ignore_errors=True)


@contextmanager
def launch_shapes(gram_kernels):
    """Count the unit-gram launches by operand shapes for the body."""
    import collections
    shapes, original = collections.Counter(), gram_kernels.unit_gram_cuda

    def recorded(u, v):
        out = original(u, v)
        shared = u.data_ptr() == v.data_ptr() and u.shape == v.shape
        shapes[(tuple(u.shape), tuple(v.shape), 'u is v' if shared else 'two operands')] += 1
        return out

    gram_kernels.unit_gram_cuda = recorded
    try:
        yield shapes
    finally:
        gram_kernels.unit_gram_cuda = original


def median_ms(torch, fn, n=MESH_TIMED):
    """The median of n host-clock ms of fn, each ending in a synchronize."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_mesh_tiles(torch, gram_kernels):
    """The kernel at the mesh path's shapes against its plain version, timed
    (CUDA events), with its bound. Returns {shape: (ms, plain ms, bound ms,
    bound by, max |kernel - plain|)}."""
    times = {}
    for A, B, M_, shared in MESH_TILE_SHAPES:
        u, v = unit_inputs(torch, A, B, M_, seed=A + 1, shared=shared)
        err = (gram_kernels.unit_gram_cuda(u, v) - gram_kernels.unit_gram_plain(u, v)
               ).abs().max().item()
        require(err <= VALUE_TOL, (A, B, M_, shared, err))
        (kernel,), (plain,) = (spread_ms(torch, [lambda: gram_kernels.unit_gram_cuda(u, v)],
                                         samples=20, calls=5),
                               spread_ms(torch, [lambda: gram_kernels.unit_gram_plain(u, v)],
                                         samples=5, calls=2))
        bound, bound_by = forward_bound_ms(A, B, M_, shared)
        times[(A, B, M_, shared)] = (kernel[1], plain[1], bound, bound_by, err)
        print(f'mesh tile ({A}, {B}, {M_}{", u is v" if shared else ", two operands"}): max '
              f'|kernel - plain| {err:.3e} (tol {VALUE_TOL}); forward ms kernel min / median / '
              f'max {kernel[0]:.4f} / {kernel[1]:.4f} / {kernel[2]:.4f} (20 samples of 5), plain '
              f'median {plain[1]:.4f}; bound {bound:.4f} ms ({bound_by}), kernel at '
              f'{bound / kernel[1]:.3f} of it', flush=True)
        del u, v
    return times


def _value_and_grad(torch, gp, x, y, at):
    """[LML, dls, ds2, dnoise] of gp at the hyperparameters `at`, float64."""
    p = [t.detach().clone().requires_grad_(True) for t in at]
    value = gp.lml(*p, x, y)
    return [value.detach().double()] + [g.double() for g in torch.autograd.grad(value, p)]


def _indices(gp, hypers, x, y, X):
    """{'<kind> S' | '<kind> T': (M,)} of gp: both kinds with non-partial T."""
    import numpy as np
    out = gp.sobol_indices(*hypers, x, y, X, kind=MESH_KINDS, error=True, is_T_partial=False)
    return {f'{kind} {key}': np.array([out[key][kind][m] for m in sorted(out[key][kind])])
            for key in ('S', 'T') for kind in MESH_KINDS}


def _table_distance(key, got, want):
    """max |got - want| / max |want|; of the squares for T."""
    import numpy as np
    if key.endswith(' T'):
        got, want = got * got, want * want
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)


def _apart(got, want) -> list:
    """max |got - want| of each of MESH_PARTS."""
    return [float((g - w).abs().max()) for g, w in zip(got, want)]


def _parts(values) -> str:
    """values, one for each of MESH_PARTS, named."""
    return ', '.join(f'{part} {v:.3e}' for part, v in zip(MESH_PARTS, values))


def mesh_reference(torch, X, Y, Xs, hypers):
    """Phase 13's one-device reference, engine='upper' with ExactLML as its
    LML (``ExactReference``), at ``hypers`` (NORTH_STAR_UPPER_OPTIMUM): the
    float32 ExactLML value and gradient (and its median ms), the float64 one
    on the same float32-rounded data, the float32 one's distance from it
    part by part and the float64 parts' sizes; the float32 LML at
    MESH_START; the float64 posterior alpha and predictions, the indices
    with T, and their spread under ULP_DRAWS one-ulp moves of the
    hyperparameters."""
    import numpy as np
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    N_ = len(X)
    one = ExactReference(DistributedGP(N_, CARD, dtype=np.float32, engine='upper'))
    x, y = one.stage(X, Y)
    at32 = tuple(torch.tensor(h, dtype=torch.float32, device=CARD) for h in hypers)
    ref = {'f32': _value_and_grad(torch, one, x, y, at32),
           'ms': median_ms(torch, lambda: _value_and_grad(torch, one, x, y, at32))}
    one64 = ExactReference(DistributedGP(N_, CARD, dtype=np.float64, engine='upper'))
    x64, y64 = one64.stage(x, y)
    ref['f64'] = _value_and_grad(torch, one64, x64, y64, tuple(t.double() for t in at32))
    ref['apart'] = _apart(ref['f32'], ref['f64'])
    ref['size'] = [float(w.abs().max()) for w in ref['f64']]
    ref['start'] = tuple(torch.tensor(h, dtype=torch.float32, device=CARD)
                         for h in (np.full(X.shape[1], MESH_START[0]), *MESH_START[1:]))
    with torch.no_grad():
        ref['start f32'] = one.lml(*ref['start'], x, y).item()
    require(all(a > 0.0 for a in ref['apart']), ('ExactLML float32 equals float64', ref['apart']))
    del one64, x64, y64
    ref['alpha'] = one.posterior_alpha(*hypers, x, y)[0].cpu().numpy()
    ref['mean'], ref['var'] = (t.cpu().numpy() for t in one.predict(*hypers, x, y, Xs))
    ref['indices'] = _indices(one, hypers, x, y, X)

    def nudged(draw):
        g = np.random.default_rng(2000 + draw)
        return tuple(np.nextafter(np.float64(h), np.where(g.random(np.shape(h)) < 0.5,
                                                          -np.inf, np.inf)) for h in hypers)

    moved = [_indices(one, nudged(d), x, y, X) for d in range(ULP_DRAWS)]
    ref['spread'] = {key: max(_table_distance(key, m[key], want) for m in moved)
                     for key, want in ref['indices'].items()}
    ref['x'], ref['y'], ref['at32'] = x, y, at32
    return ref


def mesh_engine(torch, gram_kernels, engine, mesh, X, Y, Xs, hypers, ref):
    """Phase 13a, one engine on the mesh: at MESH_START its float32 LML
    against ExactLML's; at ``hypers`` (NORTH_STAR_UPPER_OPTIMUM) its ring gram
    against the one-device gram, its float32 and float64 LML and gradient
    against float64 ExactLML's, its float64 posterior, predictions and
    indices against engine='upper''s; the same engine on the card with no
    process group, its LML and gradient bit for bit; its factor and value+grad timed;
    then its calibrate from MESH_START counted. Returns the engine's record."""
    import numpy as np
    from romcomma_tpu_torch.ops.gram import rbf_gram
    from romcomma_tpu_torch.parallel.distributed import DistributedGP, from_stored
    N_ = len(X)
    gp = DistributedGP(N_, mesh, dtype=np.float32, engine=engine)
    x, y = gp.stage(X, Y)
    at32 = ref['at32']
    s2 = float(at32[1])
    with torch.no_grad():               # one rank: stored and global order are the original
        K = gp._ops.gram(x, *at32)
        K1 = rbf_gram(ref['x'], ref['x'], at32[0], at32[1])
        K1.diagonal().add_(at32[2])
        gram_err = (K[:N_, :N_] - K1).abs().max().item()
        padding = K[N_:].clone()
        padding[:, N_:] -= torch.eye(K.shape[1] - N_, device=CARD)
        padding_err = padding.abs().max().item() + K[:N_, N_:].abs().max().item()
        del K, K1, padding
    require(gram_err <= VALUE_TOL * s2 and padding_err == 0.0, (engine, gram_err, padding_err))
    with torch.no_grad():
        start_err = abs(gp.lml(*ref['start'], x, y).item() - ref['start f32'])
    start_bound = 10 * N_ * EPS['float32'] * (MESH_START[1] / MESH_START[2] + 1.0)
    require(start_err <= start_bound, (engine, 'LML at the start', start_err, start_bound))
    # One rank factorizes the float64 gram (MeshLML).
    factor_ms = median_ms(torch, lambda: gp._ops.chol(gp._ops.gram(x, *at32, torch.float64)))
    got = _value_and_grad(torch, gp, x, y, at32)
    # The same engine on the card with no process group (S = 1, the ring's
    # collectives the identity): the same bits as on the one-rank group.
    solo = DistributedGP(N_, CARD, dtype=np.float32, engine=engine)
    solo_bits = all(bool(torch.equal(a, b)) for a, b in zip(
        _value_and_grad(torch, solo, *solo.stage(X, Y), at32), got))
    require(solo_bits, (engine, 'on one device against one NCCL rank'))
    del solo
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    valgrad_ms = median_ms(torch, lambda: _value_and_grad(torch, gp, x, y, at32))
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    apart = _apart(got, ref['f64'])
    multiples = [a / r for a, r in zip(apart, ref['apart'])]
    t0 = time.perf_counter()
    gp64 = DistributedGP(N_, mesh, dtype=np.float64, engine=engine)
    x64, y64 = gp64.stage(ref['x'], ref['y'])
    apart64 = _apart(_value_and_grad(torch, gp64, x64, y64, tuple(t.double() for t in at32)),
                     ref['f64'])
    float64_s = time.perf_counter() - t0
    del gp64, x64, y64
    shares = [a / r for a, r in zip(apart64, ref['apart'])]
    print(f'{engine} at the optimum against float64 ExactLML (sizes: {_parts(ref["size"])}): '
          f'float32 {_parts(apart)}, i.e. ' + ', '.join(f'{m:.3g}' for m in multiples)
          + ' times ExactLML float32\'s (limits '
          + ', '.join(f'{m:g}' for m in MESH_F32_MULTIPLES) + f'); float64 {_parts(apart64)}, i.e. ' + ', '.join(f'{m:.3g}' for m in shares)
          + f' of ExactLML float32\'s (limit {MESH_F64_SHARE:g}; {float64_s:.2f} s)', flush=True)
    require(all(m <= limit for m, limit in zip(multiples, MESH_F32_MULTIPLES)),
            (engine, 'float32', apart, ref['apart']))
    require(all(share <= MESH_F64_SHARE for share in shares), (engine, 'float64', apart64))
    alpha, _ = gp.posterior_alpha(*hypers, x, y)
    tables = {'alpha': from_stored(gp.plan, alpha.cpu().numpy())}
    tables['mean'], tables['var'] = (t.cpu().numpy() for t in gp.predict(*hypers, x, y, Xs))
    posterior_err = {key: _table_distance(key, tables[key], ref[key]) for key in tables}
    require(max(posterior_err.values()) <= CARD_CPU_TOL, (engine, posterior_err))
    t0 = time.perf_counter()
    indices = _indices(gp, hypers, x, y, X)
    gsa_s = time.perf_counter() - t0
    readings, failures = [], []
    for key, want in ref['indices'].items():
        apart, spread = _table_distance(key, indices[key], want), ref['spread'][key]
        require(bool(np.isfinite(indices[key]).all()), (engine, key))
        ratio = apart / spread if spread else (math.inf if apart else 0.0)
        readings.append(f'{key}{"^2" if key.endswith(" T") else ""} {apart:.2e} = {ratio:.3f} '
                        f'spreads')
        failures += [(key, apart, spread)] if ratio > ULP_SPREADS else []
    require(not failures, (engine, failures))
    torch.cuda.synchronize()
    gram_kernels.LAUNCHES = 0
    with launch_shapes(gram_kernels) as shapes:
        t0 = time.perf_counter()
        (ls_c, s2_c, noise_c), lml_c, iterations = gp.calibrate(
            X, Y, np.full(X.shape[1], MESH_START[0]), *MESH_START[1:], maxiter=MESH_MAXITER)
        torch.cuda.synchronize()
        calibrate_s = time.perf_counter() - t0
    launches = gram_kernels.LAUNCHES
    require(launches > 0 and math.isfinite(float(lml_c)), (engine, launches, lml_c))
    print(f'{engine} on an NCCL mesh of 1 rank (plan: Npad {gp.plan.Npad}, B {gp.plan.B}'
          + (f', q {gp._ops.q}' if engine == 'cyclic2' else '') + f'): ring gram against the '
          f'one-device gram max |diff| {gram_err:.3e} (tol {VALUE_TOL * s2:.3e}), padding exact; '
          f'on the card with no process group the same LML and gradient bits; '
          f'at the start, LML |diff| to ExactLML float32\'s {start_err:.3e} (phase 4 bound '
          f'{start_bound:.3e}); at the optimum LML {got[0].item():.6f} (ExactLML float32 '
          f'{ref["f32"][0].item():.6f}, float64 {ref["f64"][0].item():.6f}); float64 posterior against engine=\'upper\' '
          f'(limit {CARD_CPU_TOL}): ' + ', '.join(f'{k} {v:.2e}' for k, v in posterior_err.items())
          + f'; indices ({gsa_s:.2f} s; S and T squared, limit {ULP_SPREADS} one-ulp '
          f'spreads): ' + ', '.join(readings), flush=True)
    print(f'{engine}: value+grad {valgrad_ms:.2f} ms (median of {MESH_TIMED}; the one-device '
          f'ExactLML {ref["ms"]:.2f} ms in this run), factor (gram + Cholesky) {factor_ms:.2f} '
          f'ms, peak device memory {peak:.2f} GiB above the {held / 2 ** 30:.2f} GiB held before '
          f'it; calibrate of {MESH_MAXITER} iterations: '
          f'{iterations} iterations, LML {float(lml_c):.6f}, {calibrate_s:.2f} s, {launches} '
          f'unit-gram launches: ' + ', '.join(f'{n}x {u}x{v} {kind}'
                                              for (u, v, kind), n in sorted(shapes.items())),
          flush=True)
    return {'valgrad_ms': valgrad_ms, 'factor_ms': factor_ms, 'peak_gib': peak,
            'launches': launches, 'value': got[0].item(), 'calibrate_s': calibrate_s}


#: Phase 13c's fold of phase 4's repository: the improper fold (N=8192, L=3,
#: so L*N = 24576 = Npad at B=256), at phase 7's trained gpr.c.a.
COVARIANT_MESH_FOLD = 2
#: Phase 7 trains F diagonal (its off-diagonals frozen, the reference's
#: default); phase 13c sets each off-diagonal of F to this correlation, so
#: that every entry of dF carries weight.
COVARIANT_MESH_CORRELATION = 0.5
#: The parts of a covariant LML evaluation that phase 13c holds apart.
COVARIANT_MESH_PARTS = ('LML', 'dF', 'dnoise')
#: The covariant mesh's float32 LML evaluation against float64
#: CovariantUpperLML, part by part: within these multiples of
#: CovariantUpperLML float32's own distance from float64 there. Set from the
#: H100's readings (PERF.md): the mesh read 1.16, 128 and 3.71 times it;
#: its float32 dF is the least accurate, as the variant engines' ds2 is (a
#: sum of Bbar o unit over K^-1 formed blockwise from the in-place inverse,
#: where CovariantUpperLML takes cholesky_inverse's).
COVARIANT_MESH_F32_MULTIPLES = (4.0, 400.0, 12.0)


def _covariant_value_and_grads(torch, lml, F, noise_cov):
    """[LML, dF, dnoise] of lml(F, noise_cov), float64."""
    p = [t.detach().clone().requires_grad_(True) for t in (F, noise_cov)]
    value = lml(*p)
    return [value.detach().double()] + [g.double() for g in torch.autograd.grad(value, p)]


def _covariant_parts(values) -> str:
    """values, one for each of COVARIANT_MESH_PARTS, named."""
    return ', '.join(f'{part} {v:.3e}' for part, v in zip(COVARIANT_MESH_PARTS, values))


def covariant_mesh_point(torch, repo):
    """Phase 13c's problem: the improper fold's X and Y (float32, on the
    card), phase 7's trained lengthscales and noise covariance, and its F
    with off-diagonals F_ij = COVARIANT_MESH_CORRELATION sqrt(F_ii F_jj)."""
    import numpy as np
    from romcomma_tpu_torch.data.storage import Fold
    fold = Fold(repo, COVARIANT_MESH_FOLD)
    _, F, ls, noise = trained_covariant(torch, fold.folder / 'gpr.c.a', CARD, torch.float32)
    d = np.sqrt(np.diag(F))
    F = COVARIANT_MESH_CORRELATION * np.outer(d, d) + (1.0 - COVARIANT_MESH_CORRELATION) * np.diag(
        d * d)
    return (*fold_tensors(torch, fold, torch.float32), ls, F, noise)


def covariant_mesh_reference(torch, X, Y, ls, F, noise):
    """Phase 13c's one-device reference: CovariantUpperLML's float32 LML, dF
    and dnoise and the median ms of its value+grad, the float64 ones on the
    same float32-rounded inputs, the float32 one's distance from them part
    by part, and the float64 parts' sizes."""
    from romcomma_tpu_torch.models import gp
    at32 = [torch.tensor(a, dtype=torch.float32, device=CARD) for a in (F, noise)]
    ls32 = torch.tensor(ls, dtype=torch.float32, device=CARD)
    upper = gp.covariant_upper_lml(X, ls32, Y)
    ref = {'at32': at32, 'ls32': ls32, 'f32': _covariant_value_and_grads(torch, upper, *at32),
           'ms': median_ms(torch, lambda: _covariant_value_and_grads(torch, upper, *at32))}
    del upper
    upper = gp.covariant_upper_lml(X.double(), ls32.double(), Y.double())
    ref['f64'] = _covariant_value_and_grads(torch, upper, *(t.double() for t in at32))
    del upper
    ref['apart'] = _apart(ref['f32'], ref['f64'])
    ref['size'] = [float(w.abs().max()) for w in ref['f64']]
    require(all(a > 0.0 for a in ref['apart']),
            ('CovariantUpperLML float32 equals float64', ref['apart']))
    return ref


def covariant_mesh_engine(torch, gram_kernels, mesh, X, Y, ls, F, noise, ref):
    """Phase 13c on the mesh: DistributedCovariantGP's ring gram against the
    one-device covariant gram; its float32 and float64 LML, dF and dnoise
    against float64 CovariantUpperLML's; its factor and value+grad timed
    beside CovariantUpperLML's; then its calibrate of MESH_MAXITER
    iterations from the point, counted. Returns its record."""
    import numpy as np
    from romcomma_tpu_torch.models import gp, params
    from romcomma_tpu_torch.ops.gram import rbf_gram_covariant_unit
    from romcomma_tpu_torch.ops.linalg import cholesky
    from romcomma_tpu_torch.parallel.covariant_mesh import DistributedCovariantGP
    N_, L_ = Y.shape
    LN = N_ * L_
    at32, ls32 = ref['at32'], ref['ls32']
    dgp = DistributedCovariantGP(N_, L_, mesh, dtype=np.float32)
    st = dgp.stage(X, Y, ls32)
    with torch.no_grad():               # one rank: stored and global order are the original
        K = dgp._gram(st, *at32)
        unit4 = rbf_gram_covariant_unit(X, ls32)
        K1 = gp._assemble(unit4, *at32)
        gram_err = (K[:LN, :LN] - K1).abs().max().item()
        bitwise = bool(torch.equal(K[:LN, :LN], K1))
        padding = K[LN:].clone()
        padding[:, LN:] -= torch.eye(K.shape[1] - LN, device=CARD)
        padding_err = padding.abs().max().item() if padding.numel() else 0.0
        padding_err += K[:LN, LN:].abs().max().item() if K.shape[1] > LN else 0.0
        del K, K1, padding
        upper_factor_ms = median_ms(torch, lambda: cholesky(gp._assemble(unit4, *at32)))
        del unit4
    gram_tol = VALUE_TOL * float(np.abs(F).max())
    require(gram_err <= gram_tol and padding_err == 0.0, ('covariant gram', gram_err, padding_err))
    factor_ms = median_ms(torch, lambda: dgp.engine.chol(dgp._gram(st, *at32)))
    lml = dgp.lml_fn(st)
    got = _covariant_value_and_grads(torch, lml, *at32)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    valgrad_ms = median_ms(torch, lambda: _covariant_value_and_grads(torch, lml, *at32))
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    apart = _apart(got, ref['f64'])
    multiples = [a / r for a, r in zip(apart, ref['apart'])]
    t0 = time.perf_counter()
    dgp64 = DistributedCovariantGP(N_, L_, mesh, dtype=np.float64)
    st64 = dgp64.stage(X.double(), Y.double(), ls32.double())
    apart64 = _apart(_covariant_value_and_grads(torch, dgp64.lml_fn(st64),
                                                *(t.double() for t in at32)), ref['f64'])
    float64_s = time.perf_counter() - t0
    del dgp64, st64
    shares = [a / r for a, r in zip(apart64, ref['apart'])]
    print(f'covariant mesh (plan: Npad {dgp.plan.Npad}, B {dgp.plan.B}, q {dgp.engine.q}) at '
          f'L*N={LN}: ring gram against the one-device covariant gram max |diff| {gram_err:.3e} '
          f'(tol {gram_tol:.3e}), {"bit for bit" if bitwise else "not bit for bit"}, padding '
          f'exact; against float64 CovariantUpperLML (sizes: {_covariant_parts(ref["size"])}): '
          f'CovariantUpperLML float32 {_covariant_parts(ref["apart"])}; the mesh float32 '
          f'{_covariant_parts(apart)}, i.e. ' + ', '.join(f'{m:.3g}' for m in multiples)
          + ' times CovariantUpperLML float32\'s (limits '
          + ', '.join(f'{m:g}' for m in COVARIANT_MESH_F32_MULTIPLES) + f'); float64 '
          f'{_covariant_parts(apart64)}, i.e. ' + ', '.join(f'{m:.3g}' for m in shares)
          + f' of it (limit {MESH_F64_SHARE:g}; {float64_s:.2f} s); LML float32 '
          f'{got[0].item():.6f}, CovariantUpperLML float32 {ref["f32"][0].item():.6f}, float64 '
          f'{ref["f64"][0].item():.6f}', flush=True)
    require(all(m <= limit for m, limit in zip(multiples, COVARIANT_MESH_F32_MULTIPLES)),
            ('covariant mesh', 'float32', apart, ref['apart']))
    require(all(share <= MESH_F64_SHARE for share in shares),
            ('covariant mesh', 'float64', apart64))
    raw = params.covariant_init(F, ls, noise, on=CARD)
    torch.cuda.synchronize()
    gram_kernels.LAUNCHES = 0
    with launch_shapes(gram_kernels) as shapes:
        t0 = time.perf_counter()
        _, lml_c, iterations, stop = dgp.calibrate(
            X, Y, raw, params.covariant_mask(kernel_covariance=True), maxiter=MESH_MAXITER)
        torch.cuda.synchronize()
        calibrate_s = time.perf_counter() - t0
    launches = gram_kernels.LAUNCHES
    require(launches > 0 and math.isfinite(float(lml_c)), ('covariant mesh', launches, lml_c))
    print(f'covariant mesh: value+grad {valgrad_ms:.2f} ms (median of {MESH_TIMED}; '
          f'CovariantUpperLML {ref["ms"]:.2f} ms in this run), factor (gram + Cholesky) '
          f'{factor_ms:.2f} ms (CovariantUpperLML\'s assembly + Cholesky {upper_factor_ms:.2f} '
          f'ms), peak device memory {peak:.2f} GiB above the {held / 2 ** 30:.2f} GiB held '
          f'before it; calibrate of {MESH_MAXITER} iterations: {iterations} iterations, LML '
          f'{float(lml_c):.6f}, {calibrate_s:.2f} s, scipy: {stop}; {launches} unit-gram '
          f'launches: ' + ', '.join(f'{n}x {u}x{v} {kind}'
                                    for (u, v, kind), n in sorted(shapes.items())), flush=True)
    return {'valgrad_ms': valgrad_ms, 'factor_ms': factor_ms, 'peak_gib': peak,
            'launches': launches, 'calibrate_s': calibrate_s}


def covariant_mesh_phase(torch, gram_kernels, mesh, repo):
    """Phase 13c: the covariant mesh on ``mesh`` at phase 7's improper fold.
    Returns (its calibrate's unit-gram launches, its point as host arrays,
    the one-device reference)."""
    t0 = time.perf_counter()
    X, Y, ls, F, noise = covariant_mesh_point(torch, repo)
    ref = covariant_mesh_reference(torch, X, Y, ls, F, noise)
    print(f'one-device covariant reference at L*N={X.shape[0] * Y.shape[1]}: CovariantUpperLML '
          f'float32 value+grad {ref["ms"]:.2f} ms (median of {MESH_TIMED}), LML '
          f'{ref["f32"][0].item():.6f} (float64 {ref["f64"][0].item():.6f}); F off-diagonal '
          f'correlation {COVARIANT_MESH_CORRELATION}; {time.perf_counter() - t0:.2f} s',
          flush=True)
    launches = covariant_mesh_engine(torch, gram_kernels, mesh, X, Y, ls, F, noise,
                                     ref)['launches']
    point = tuple(t.cpu().numpy() for t in (X, Y)) + (ls, F, noise)
    return launches, point, ref


def mesh_phase(torch, gram_kernels, repo):
    """Phase 13a: the multi-device variant route on an NCCL group of world
    size 1 at the north star's problem, both engines; then 13c, the
    covariant mesh, in the same group; then graft_entry.dryrun_multichip(1).
    Returns (unit-gram launches of the engines' and the covariant mesh's
    calibrates, the mesh tiles' times, the one-device reference, 13c's
    point and its reference)."""
    import numpy as np
    from romcomma_tpu_torch import graft_entry, north_star
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    N_, M_ = NORTH_STAR[:2]
    X, Y = north_star.problem(N_, M_)
    Xs = np.random.default_rng(SEED).standard_normal((256, M_))
    hypers = upper_hypers()
    tiles = check_mesh_tiles(torch, gram_kernels)
    t0 = time.perf_counter()
    ref = mesh_reference(torch, X, Y, Xs, hypers)
    print(f'one-device reference (engine=\'upper\') at N={N_}: ExactLML float32 value+grad {ref["ms"]:.2f} ms '
          f'(median of {MESH_TIMED}), LML {ref["f32"][0].item():.6f} (float64 '
          f'{ref["f64"][0].item():.6f}); at the optimum float32 against float64 '
          f'{_parts(ref["apart"])}, float64 sizes {_parts(ref["size"])}; indices\' one-ulp '
          f'spreads ' + ', '.join(
              f'{k} {v:.2e}' for k, v in ref['spread'].items())
          + f'; {time.perf_counter() - t0:.2f} s', flush=True)
    launches = 0
    with nccl_group(torch):
        mesh = make_n_mesh()
        require(mesh.size() == 1, mesh)
        for engine in MESH_ENGINES:
            launches += mesh_engine(torch, gram_kernels, engine, mesh, X, Y, Xs, hypers,
                                    ref)['launches']
        del X, Y, Xs
        covariant_launches, point, covariant_ref = covariant_mesh_phase(torch, gram_kernels,
                                                                        mesh, repo)
        t0 = time.perf_counter()
        graft_entry.dryrun_multichip(1)
        print(f'graft_entry.dryrun_multichip(1) in the group: {time.perf_counter() - t0:.2f} s',
              flush=True)
    return launches + covariant_launches, tiles, ref, point, covariant_ref


def _mesh_rank(rank, size, hypers, point):
    """Phase 13b on one of several ranks: each engine's float32 LML and
    gradient at the north star's problem of ``size`` (N, M), at ``hypers``,
    and the covariant mesh's float32 LML, dF and dnoise at ``point`` (X, Y,
    lengthscales, F, noise covariance: 13c's), on this rank's device, and on
    a card each value+grad's median ms."""
    import numpy as np
    import torch
    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.base.definitions import device
    from romcomma_tpu_torch.parallel.covariant_mesh import DistributedCovariantGP
    from romcomma_tpu_torch.parallel.distributed import DistributedGP, make_n_mesh
    X, Y = north_star.problem(*size)
    at = tuple(torch.tensor(h, dtype=torch.float32, device=device()) for h in hypers)
    out = {}
    for engine in MESH_ENGINES:
        gp = DistributedGP(len(X), make_n_mesh(), dtype=np.float32, engine=engine)
        x, y = gp.stage(X, Y)
        out[engine] = [t.cpu().numpy() for t in _value_and_grad(torch, gp, x, y, at)]
        if x.is_cuda:
            out[engine + ' ms'] = median_ms(torch, lambda: _value_and_grad(torch, gp, x, y, at))
    Xc, Yc, ls, F, noise = point
    dgp = DistributedCovariantGP(*Yc.shape, make_n_mesh(), dtype=np.float32)
    lml = dgp.lml_fn(dgp.stage(Xc, Yc, ls))
    at = [torch.tensor(a, dtype=torch.float32, device=device()) for a in (F, noise)]
    out['covariant'] = [t.cpu().numpy() for t in _covariant_value_and_grads(torch, lml, *at)]
    if at[0].is_cuda:
        out['covariant ms'] = median_ms(torch, lambda: _covariant_value_and_grads(torch, lml, *at))
    return out


def mesh_ranks(S, size, hypers, point, backend, timeout):
    """_mesh_rank on S spawned ranks over ``backend``; requires every rank's
    LMLs and gradients to be the same bits. Returns every rank's record."""
    import numpy as np
    from romcomma_tpu_torch.parallel import spawn
    results = spawn.run(_mesh_rank, S, size, hypers, point, backend=backend, timeout=timeout)
    for engine in MESH_ENGINES + ('covariant',):
        require(all(all(np.array_equal(a, b) for a, b in zip(r[engine], results[0][engine]))
                    for r in results[1:]), (engine, S, 'ranks differ'))
    return results


def mesh_ranks_phase(torch, ref, hypers, point, covariant_ref):
    """Phase 13b: where the machine has several cards, both engines and the
    covariant mesh on S = min(MESH_RANKS, cards) NCCL ranks, spawned, at
    NORTH_STAR_UPPER_OPTIMUM ``hypers`` and 13c's ``point``: every rank's LMLs and
    gradients the same bits, held to float64 ExactLML's and
    CovariantUpperLML's as in 13a and 13c."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f'phase 13b not run: this machine has {count} CUDA device(s), and NCCL takes one '
              f'rank per card, so a mesh of several ranks needs two cards or more', flush=True)
        return
    S = min(MESH_RANKS, count)
    results = mesh_ranks(S, NORTH_STAR[:2], hypers, point, 'nccl', 900)
    for engine in MESH_ENGINES:
        apart = _apart([torch.as_tensor(g, device=CARD) for g in results[0][engine]],
                       ref['f64'])
        multiples = [a / r for a, r in zip(apart, ref['apart'])]
        require(all(m <= limit for m, limit in zip(multiples, MESH_RANKS_F32_MULTIPLES)),
                (engine, S, apart, ref['apart']))
        print(f'{engine} on {S} NCCL ranks: every rank the same bits; against float64 ExactLML '
              f'{_parts(apart)}, i.e. ' + ', '.join(f'{m:.3g}' for m in multiples) + ' times '
              f'ExactLML float32\'s; value+grad ' + ', '.join(f'{r[engine + " ms"]:.2f}'
                                                             for r in results) + ' ms by rank',
              flush=True)
    apart = _apart([torch.as_tensor(g, device=CARD) for g in results[0]['covariant']],
                   covariant_ref['f64'])
    multiples = [a / r for a, r in zip(apart, covariant_ref['apart'])]
    require(all(m <= limit for m, limit in zip(multiples, COVARIANT_MESH_F32_MULTIPLES)),
            ('covariant mesh', S, apart, covariant_ref['apart']))
    print(f'covariant mesh on {S} NCCL ranks: every rank the same bits; against float64 '
          f'CovariantUpperLML {_covariant_parts(apart)}, i.e. '
          + ', '.join(f'{m:.3g}' for m in multiples) + ' times CovariantUpperLML float32\'s; '
          'value+grad ' + ', '.join(f'{r["covariant ms"]:.2f}' for r in results) + ' ms by rank',
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
    batch_err, batch_times = check_batched(torch, gram_kernels)
    print(f'phase 3: {time.perf_counter() - t:.2f} s', flush=True)

    t = phase(f'4. main path: OAKLEY2004 N={N} M={M} K={K}, run.gpr maxiter={MAXITER}, float32')
    repo, launches, seconds, worst = main_path(torch, user, gram_kernels)
    MAIN_PATH.update(gpr_seconds=seconds, gpr_launches=launches)
    print(f'phase 4: {time.perf_counter() - t:.2f} s (run.gpr {seconds:.2f} s); '
          f'worst LML error / bound {worst:.3e}', flush=True)

    t = phase('5. profile of one float32 LML value-and-gradient')
    profile_value_and_grad(torch)
    print(f'phase 5: {time.perf_counter() - t:.2f} s', flush=True)

    t = phase(f'6. GSA on the card: run.gsa, all kinds, errors, N={N} M={M} L=3, float64')
    gsa_main_path(torch, user, gram_kernels, repo)
    gsa_card_against_cpu(torch, user)
    print(f'phase 6: {time.perf_counter() - t:.2f} s', flush=True)

    t = phase(f'7. covariant MOGP: run.gpr (is_covariant=True, lengthscales frozen) on phase 4\'s '
              f'repository, L*N = 12288, 12288, 24576, maxiter={MAXITER}, float32; its GSA')
    covariant_launches, covariant_seconds, covariant_worst = covariant_main_path(
        torch, user, gram_kernels, repo)
    profile_covariant(torch, gram_kernels, repo)
    gradient_worst = check_covariant_gradients(torch, gram_kernels, repo)
    covariant_gsa(torch, user, gram_kernels, repo)
    covariant_card_against_cpu(torch, user)
    print(f'phase 7: {time.perf_counter() - t:.2f} s (run.gpr covariant {covariant_seconds:.2f} s); '
          f'worst LML error / bound {covariant_worst:.3e}; worst CovariantUpperLML error / '
          f'limit {gradient_worst:.3e}', flush=True)

    t = phase(f'8. the large-N variant route: the north star N={NORTH_STAR[0]} M={NORTH_STAR[1]}; '
              f'run.gpr N={LARGE_N} M={M} K={LARGE_K}; DistributedGP card against the CPU; the '
              f'north star N={NORTH_STAR_LARGE[0]} M={NORTH_STAR_LARGE[1]}')
    north_star_launches = north_star_phase(torch, gram_kernels)
    large_launches, large_seconds, large_worst, exact_worst = large_route_phase(
        torch, user, gram_kernels)
    distributed_card_against_cpu(torch)
    t_large = time.perf_counter()
    large_star_launches, strip_err = north_star_large_phase(torch, gram_kernels)
    t_stream = time.perf_counter()
    stream_launches, stream_tiles = streaming_phase(torch, gram_kernels)
    print(f'phase 8: {time.perf_counter() - t:.2f} s (run.gpr N={LARGE_N} {large_seconds:.2f} s; '
          f'8d {t_stream - t_large:.2f} s; 8e {time.perf_counter() - t_stream:.2f} s); worst LML '
          f'error / bound {large_worst:.3e}; worst ExactLML error / limit {exact_worst:.3e}',
          flush=True)

    t = phase(f'9. ROM: the N={ROM_N} M={ROM_M} planted plane, \'sobol\' for '
              f'{ROM_SOBOL_ITERATIONS} iterations and \'active_subspace\' for '
              f'{ROM_ACTIVE_ITERATIONS}, float32; the card against the CPU')
    sobol, sobol_launches = rom_run(torch, gram_kernels, ROM_SOBOL_ITERATIONS, 'sobol')
    require(sobol['S_m_history'][-1] >= ROM_S_M_MIN, (sobol['S_m_history'], ROM_S_M_MIN))
    active, active_launches = rom_run(torch, gram_kernels, ROM_ACTIVE_ITERATIONS,
                                      'active_subspace')
    rom_card_against_cpu(torch)
    print(f'phase 9: {time.perf_counter() - t:.2f} s (ROM sobol {sobol["rom_s"]:.2f} s, '
          f'active_subspace {active["rom_s"]:.2f} s)', flush=True)

    t = phase(f'10. the sequential loop: run.gpr and run.gsa with fold_parallel=False on a copy '
              f'of phase 4\'s sampled repository, beside phases 4 and 6')
    sequential_phase(torch, user, gram_kernels, repo)
    print(f'phase 10: {time.perf_counter() - t:.2f} s', flush=True)

    t = phase(f'11. csv_script -r -a on a user CSV (OAKLEY2004, N={CSV_N}, M={CSV_M}, L=3): '
              f'K={CSV_K} folds in lockstep, the improper fold, GSA with errors; float32')
    csv_launches, csv_batched, csv_seconds = csv_phase(torch, user, gram_kernels)
    print(f'phase 11: {time.perf_counter() - t:.2f} s (csv_script {csv_seconds:.2f} s)', flush=True)

    t = phase(f'12. benchmark_script {" ".join(SWEEP_ARGV)}: sweep cell 325 (ALL, L={SWEEP_L}, '
              f'M={SWEEP_M}, N=8000, noise 0.1, K=-2); float32')
    sweep_launches, sweep_batched, sweep_seconds = sweep_phase(torch, user, gram_kernels)
    print(f'phase 12: {time.perf_counter() - t:.2f} s (benchmark_script {sweep_seconds:.2f} s)',
          flush=True)

    t = phase(f'13. the multi-device routes: DistributedGP engine=\'cyclic\' and '
              f'\'cyclic2\' on an NCCL group of 1 rank, N={NORTH_STAR[0]} M={NORTH_STAR[1]}, '
              f'float32; the covariant mesh at L*N={3 * N}; graft_entry.dryrun_multichip(1); '
              f'several ranks where there are cards')
    mesh_launches, mesh_tiles, mesh_ref, point, covariant_ref = mesh_phase(torch, gram_kernels,
                                                                           repo)
    mesh_ranks_phase(torch, mesh_ref, upper_hypers(), point, covariant_ref)
    print(f'phase 13: {time.perf_counter() - t:.2f} s', flush=True)

    kernel_ms, plain_ms, bound_ms, bound_by = times[(8192, 8192, 30)]
    batch_ms, batch_plain_ms, batch_bound_ms, batch_bound_by = batch_times[(6, 4096, 4096, 30)]
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'unit_gram', 'route': 'cuda',
        'source': 'romcomma_tpu_torch/csrc/unit_gram.cu',
        'replaces': 'romcomma_tpu/ops/pallas_kernels.py:59',
        'launches': (launches + covariant_launches + north_star_launches + large_launches
                     + large_star_launches + stream_launches + sobol_launches + active_launches
                     + csv_launches + sweep_launches + mesh_launches),
        'max_abs_err': max(max_err, strip_err, *(tile[4] for tile in mesh_tiles.values()),
                           *(tile[4] for tile in stream_tiles.values())),
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': None}, {
        'name': 'unit_gram (batched launch)', 'route': 'cuda',
        'source': 'romcomma_tpu_torch/csrc/unit_gram.cu',
        'replaces': 'romcomma_tpu/ops/pallas_kernels.py:84',
        'launches': (MAIN_PATH['batched_launches'] + MAIN_PATH['large_batched_launches']
                     + csv_batched + sweep_batched),
        'max_abs_err': batch_err,
        'ms': batch_ms, 'plain_ms': batch_plain_ms, 'bound_ms': batch_bound_ms,
        'bound_by': batch_bound_by, 'library_ms': None}]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
