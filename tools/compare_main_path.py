#!/usr/bin/env python3
"""Run phases 4 and 5 of one checkout's ``chip_smoke.py`` in this process:
run.gpr at N=8192, M=30 in float32 (the variant main path) and the profiles
of one LML value+grad at N=4096 and 8192. It needs a CUDA device.

To compare two versions on the same card, unpack each into a directory that
``.gitignore`` lists and run them in turns, each in a process of its own:

    git archive <commit> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    for d in parent change change parent; do
        python3 tools/compare_main_path.py build/$d
    done

Each run ends with one line ``RESULT <dir>: run.gpr <s> s, <n> launches``.
"""

from __future__ import annotations

import os
import sys

os.environ['ROMCOMMA_X64'] = '0'          # float32 training: the kernel's route
checkout = os.path.abspath(sys.argv[1])
sys.path.insert(0, checkout)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from romcomma_tpu_torch import user  # noqa: E402
from romcomma_tpu_torch.ops import gram_kernels  # noqa: E402

if not chip_smoke.__file__.startswith(checkout):
    sys.exit(f'chip_smoke came from {chip_smoke.__file__}, not from {checkout}')
if not torch.cuda.is_available():
    sys.exit('compare_main_path: no CUDA device')
gram_kernels.build()
gram_kernels._library()
repo, launches, seconds, worst = chip_smoke.main_path(torch, user, gram_kernels)
chip_smoke.profile_value_and_grad(torch)
print(f'RESULT {sys.argv[1]}: run.gpr {seconds:.2f} s, {launches} launches, worst LML error / '
      f'bound {worst:.3e}', flush=True)
