#!/usr/bin/env python3
"""Run phase 13 of ``chip_smoke.py`` alone: the north star (phase 8a's
``north_star.run`` at N=20000, M=30, float32) for its optimum, then both mesh
engines on an NCCL group of this process (``mesh_phase``) and, where the
machine has several cards, on several ranks (``mesh_ranks_phase``). It needs
a CUDA device and takes ~3 minutes on one H100.

    python3 tools/mesh_phase.py

It prints the card, the north star's record, phase 13's lines and one line
``phase 13 <s> s, <n> launches`` (the engines' calibrates).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ['ROMCOMMA_X64'] = '0'          # float32 training: the kernel's route
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch

    import chip_smoke
    from romcomma_tpu_torch import north_star
    from romcomma_tpu_torch.ops import gram_kernels
    chip_smoke.require(torch.cuda.is_available(), 'no CUDA device')
    print(chip_smoke.card_line(), torch.__version__, torch.version.cuda, flush=True)
    gram_kernels.build()
    out, state = north_star.run(*chip_smoke.NORTH_STAR)
    print(json.dumps(out), flush=True)
    chip_smoke.MAIN_PATH['north_star_hypers'] = tuple(state[k].detach().cpu().numpy()
                                                      for k in ('ls', 's2', 'noise'))
    del state
    t0 = time.perf_counter()
    launches, _, reference = chip_smoke.mesh_phase(torch, gram_kernels)
    chip_smoke.mesh_ranks_phase(torch, reference, chip_smoke.MAIN_PATH['north_star_hypers'])
    print(f'phase 13 {time.perf_counter() - t0:.2f} s, {launches} launches', flush=True)


if __name__ == '__main__':
    main()
