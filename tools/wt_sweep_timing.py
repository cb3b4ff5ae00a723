#!/usr/bin/env python3
"""Time, on one NVIDIA GPU, the GSA's W/T error sweep kernel
(``gsa/sweep_kernel.py``) at the north star's shape (one ARD-RBF output, N
rows, M inputs, first-order and total kinds, T partial: the single-sweep
mode). Runs ``chip_smoke.sweep_kernel_phase`` (the kernel's chunk against
the plain ``_run_chunk``, its sweep against the plain loop, its bound by the
float64 instructions the sweep needs), then times the whole ``error_scan``
and the kernel at other tile shapes, counts each compiled variant's static
float64 instructions in its own PTX, and records the spans of one
first-order and total pass ('gsa.wt_sweep' with its launches). Prints one
JSON line, with the card's name and power limit.

    python3 tools/wt_sweep_timing.py [N] [M] [reps] [tiles] [ptx_dir]

``tiles``: ``BNxBCxWARPS`` entries joined by commas (default: the module's);
``ptx_dir``: a directory to write each compiled variant's PTX into.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

#: A compiled variant's constexpr arguments, its key in the PTX counts.
VARIANT = ('IS_PSI', 'REVERSE', 'EMIT_SINGLE', 'EMIT_ACC', 'EMIT_LAST', 'BN', 'BC', 'num_warps')


def card() -> dict:
    query = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                           capture_output=True, text=True).stdout.strip()
    import triton
    return {'card': query, 'torch': torch.__version__, 'cuda': torch.version.cuda,
            'triton': triton.__version__, 'python': sys.version.split()[0]}


def seconds(fn, reps: int) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


class Capture:
    """The kernel's launcher, keeping the float64 instruction counts of the
    PTX of each compiled variant it launches, keyed by the variant's
    constexprs, with the compiled kernel's own hash; and its PTX."""

    def __init__(self, kernel):
        self.kernel, self.counts, self.ptx = kernel, {}, {}

    def __getitem__(self, grid):
        def launch(*args, **kwargs):
            handle = self.kernel[grid](*args, **kwargs)
            key = ' '.join(f'{name}={kwargs[name]}' for name in VARIANT)
            if key not in self.counts:
                self.ptx[key] = handle.asm['ptx']
                self.counts[key] = {'hash': getattr(handle, 'hash', None),
                                    'f64': chip_smoke.f64_counts(self.ptx[key])}
            return handle
        return launch


def main(N: int = 20000, M: int = 30, reps: int = 5, tiles: str = '', ptx_dir: str = ''):
    from romcomma_tpu_torch.base import tracing
    from romcomma_tpu_torch.base.definitions import pinned_device
    from romcomma_tpu_torch.gsa import factorized_errors as fe, sweep_kernel
    line = card()
    chip_smoke.SWEEP_SHAPE = (N, M)
    with pinned_device(torch.device('cuda')):
        capture = Capture(sweep_kernel._build())
        sweep_kernel._KERNEL = capture
        line['sweep_kernel_phase'] = chip_smoke.sweep_kernel_phase(torch)
        line['exp_f64'] = chip_smoke.exp_f64_counts(torch)
        cal = chip_smoke.sweep_calibrator(torch, N, M)
        need = {'single': True, 'suffix': True}
        kinds = tuple(k for k in fe.KINDS if need.get(k) or k == 'prefix')
        layout = fe._member_layout(cal)
        K = fe._pack([fe._prep(cal, kinds, False)], layout, kinds, False)

        def kernel_chunk():
            fe._run_chunk_kernel(K, layout, kinds, False, slice(0, N))

        line['error_scan_s'] = seconds(lambda: fe.error_scan(cal, need), reps)
        shapes = [tuple(int(v) for v in t.split('x')) for t in tiles.split(',') if t]
        line['tiles'] = []
        default = (sweep_kernel.BLOCK_ROWS, sweep_kernel.BLOCK_COLS, sweep_kernel.WARPS)
        for bn, bc, warps in shapes:
            sweep_kernel.BLOCK_ROWS, sweep_kernel.BLOCK_COLS, sweep_kernel.WARPS = bn, bc, warps
            line['tiles'].append({'tile': [bn, bc, warps],
                                  'kernel_chunk_s': seconds(kernel_chunk, reps)})
        sweep_kernel.BLOCK_ROWS, sweep_kernel.BLOCK_COLS, sweep_kernel.WARPS = default
        line['ptx'] = capture.counts
        if ptx_dir:
            Path(ptx_dir).mkdir(parents=True, exist_ok=True)
            for key, ptx in capture.ptx.items():
                (Path(ptx_dir) / (key.replace(' ', '.').replace('=', '') + '.ptx')).write_text(ptx)
        # One pass of first-order and total slices under the program's spans.
        mode = tracing.mode('on')
        tracing.reset()
        try:
            cal.marginalize_intervals(tuple((m, m + 1) for m in range(M))
                                      + tuple((m + 1, M) for m in range(M)))
            line['spans'] = [{key: s[key] for key in ('name', 'attrs', 'host_ms', 'device_ms')}
                             for s in tracing.spans()]
        finally:
            tracing.mode(mode)
            tracing.reset()
        line['launches'] = sweep_kernel.LAUNCHES
    print(json.dumps(line))


if __name__ == '__main__':
    args = sys.argv[1:]
    main(*(int(a) for a in args[:3]), *args[3:5])
