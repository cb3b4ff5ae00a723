#!/usr/bin/env python3
"""Time the unit-gram kernel against an earlier version of its source, on one
NVIDIA GPU, in one process, so that both times come from the same card.

    git show <commit>:romcomma_tpu_torch/csrc/unit_gram.cu > build/unit_gram_earlier.cu
    python3 tools/unit_gram_baseline.py build/unit_gram_earlier.cu [--run-gpr]

The earlier source must export the first version's C entry,
``unit_gram_f32(u, v, out, A, B, M, stream)``. It is built with the same nvcc
flags as the current kernel. Both run at the main path's shapes with one
operand (u is v), in turns, timed as ``chip_smoke.py`` phase 3 times them
(CUDA events around 10 back-to-back calls, 50 samples, after warm-up); the
earlier one is also checked against the plain version first. With
``--run-gpr``, ``chip_smoke.py``'s main path (run.gpr at N=8192, M=30 in
float32) then runs once through each kernel, the current one first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def build_earlier(source: Path) -> ctypes.CDLL:
    from romcomma_tpu_torch.ops import gram_kernels
    library = gram_kernels.BUILD_DIR / f'{source.stem}-earlier.so'
    library.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([gram_kernels._nvcc(), *gram_kernels.NVCC_FLAGS, '-o', str(library), str(source)],
                   check=True)
    earlier = ctypes.CDLL(str(library))
    earlier.unit_gram_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    earlier.unit_gram_f32.restype = ctypes.c_int
    return earlier


def main(source: str, run_gpr: bool) -> int:
    import torch
    if not torch.cuda.is_available():
        print('unit_gram_baseline: no CUDA device.', file=sys.stderr)
        return 1
    os.environ['ROMCOMMA_X64'] = '0'          # float32 training, as chip_smoke.py runs it
    from romcomma_tpu_torch import user
    from romcomma_tpu_torch.ops import gram_kernels
    earlier = build_earlier(Path(source).resolve())
    print(chip_smoke.card_line(), flush=True)
    for A, B, M in chip_smoke.TIMED_SHAPES:
        u, _ = chip_smoke.unit_inputs(torch, A, B, M, seed=7, shared=True)

        def run_earlier():
            out = torch.empty((A, A), dtype=torch.float32, device='cuda')
            error = earlier.unit_gram_f32(u.data_ptr(), u.data_ptr(), out.data_ptr(), A, A, M,
                                          torch.cuda.current_stream().cuda_stream)
            chip_smoke.require(error == 0, f'earlier kernel launch failed with CUDA error {error}')
            return out

        err = (run_earlier() - gram_kernels.unit_gram_plain(u, u)).abs().max().item()
        chip_smoke.require(err <= chip_smoke.VALUE_TOL, (A, err))
        (e0, e1, e2), (n0, n1, n2) = chip_smoke.spread_ms(
            torch, [run_earlier, lambda: gram_kernels.unit_gram_cuda(u, u)])
        bound, bound_by = chip_smoke.forward_bound_ms(A, B, M, shared=True)
        print(f'({A}, {B}, {M}, u is v) forward ms per call, min / median / max: earlier '
              f'{e0:.4f} / {e1:.4f} / {e2:.4f} (share of bound {bound / e1:.3f}); current '
              f'{n0:.4f} / {n1:.4f} / {n2:.4f} (share {bound / n1:.3f}); bound {bound:.4f} '
              f'({bound_by})', flush=True)
    if run_gpr:
        current = gram_kernels.unit_gram_cuda

        def earlier_cuda(u, v):
            if u.dim() == 3:       # the earlier kernel has no batch: one launch per member
                return torch.stack([earlier_cuda(a, b) for a, b in zip(u, v)])
            out = torch.empty((u.shape[0], v.shape[0]), dtype=torch.float32, device=u.device)
            error = earlier.unit_gram_f32(u.data_ptr(), v.data_ptr(), out.data_ptr(), u.shape[0],
                                          v.shape[0], u.shape[1],
                                          torch.cuda.current_stream().cuda_stream)
            chip_smoke.require(error == 0, f'earlier kernel launch failed with CUDA error {error}')
            gram_kernels.LAUNCHES += 1
            return out

        for label, kernel in (('current', current), ('earlier', earlier_cuda)):
            gram_kernels.unit_gram_cuda = kernel
            try:
                _, launches, seconds, worst = chip_smoke.main_path(torch, user, gram_kernels)
            finally:
                gram_kernels.unit_gram_cuda = current
            print(f'run.gpr through the {label} kernel: {seconds:.2f} s, {launches} launches, '
                  f'worst LML error / bound {worst:.3e}', flush=True)
    return 0


if __name__ == '__main__':
    arguments = sys.argv[1:]
    if len(arguments) not in (1, 2) or arguments[1:] not in ([], ['--run-gpr']):
        sys.exit(__doc__)
    sys.exit(main(arguments[0], run_gpr=len(arguments) == 2))
