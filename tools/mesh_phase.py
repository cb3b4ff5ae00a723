#!/usr/bin/env python3
"""Run phase 13 of ``chip_smoke.py`` alone: phases 4 and 7's run.gpr on
OAKLEY2004 at N=8192 (the variant, then the covariant pass) for 13c's
trained covariant model; then, at the north star's problem (N=20000, M=30,
float32) and ``chip_smoke.NORTH_STAR_UPPER_OPTIMUM``, both mesh engines and the
covariant mesh on an NCCL group of this process (``mesh_phase``) and, where
the machine has several cards, on several ranks (``mesh_ranks_phase``). It
needs a CUDA device and takes ~5 minutes on one H100.

    python3 tools/mesh_phase.py

It prints the card, phases 4, 7 and 13's lines and
one line ``phase 13 <s> s, <n> launches`` (the engines' and the covariant
mesh's calibrates).
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

os.environ['ROMCOMMA_X64'] = '0'          # float32 training: the kernel's route
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch

    import chip_smoke
    from romcomma_tpu_torch import user
    from romcomma_tpu_torch.ops import gram_kernels
    chip_smoke.require(torch.cuda.is_available(), 'no CUDA device')
    print(chip_smoke.card_line(), torch.__version__, torch.version.cuda, flush=True)
    gram_kernels.build()
    repo = chip_smoke.main_path(torch, user, gram_kernels)[0]
    chip_smoke.covariant_main_path(torch, user, gram_kernels, repo)
    t0 = time.perf_counter()
    launches, _, reference, point, covariant_reference = chip_smoke.mesh_phase(
        torch, gram_kernels, repo)
    chip_smoke.mesh_ranks_phase(torch, reference, chip_smoke.upper_hypers(), point,
                                covariant_reference)
    print(f'phase 13 {time.perf_counter() - t0:.2f} s, {launches} launches', flush=True)


if __name__ == '__main__':
    main()
