"""Faults that perfbench/faults.py has no hook for, planted in the program
underneath a run to show that the comparison which decides ``correct``
catches them; none is used by a benchmark run:

  - covariant_half: half of the batch left out: the second half of the
    stacked outputs handed to the covariant LML dropped;
  - covariant_alter: the covariant LML off by 1 %;
  - folds_alter: the fold-batched Sobol' pass's T off by 10 %, every fold
    and slice (faults.py's 'alter' acts on the one-GP pass).

'unchanged' and 'half' of perfbench/faults.py act on these cells as they
are. To read the comparison with one planted, on the card:

    python3 perfbench/faults_covariant.py --workload <cell> --seeds 11,12 --seconds <s> --mode covariant_half
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def covariant_half():
    from romcomma_tpu_torch.models import gp
    upper = gp.CovariantUpperLML.apply

    def half(F, noise_cov, unit4, yy):
        yy = yy.clone()
        yy[yy.shape[0] // 2:] = 0.0
        return upper(F, noise_cov, unit4, yy)

    class CovariantHalf(gp.CovariantUpperLML):
        apply = staticmethod(half)
    gp.CovariantUpperLML = CovariantHalf


def covariant_alter():
    from romcomma_tpu_torch.models import gp
    upper = gp.CovariantUpperLML.apply

    class CovariantAltered(gp.CovariantUpperLML):
        apply = staticmethod(lambda *args: upper(*args) * 1.01)
    gp.CovariantUpperLML = CovariantAltered


def folds_alter():
    from romcomma_tpu_torch.gsa import calibrators
    folds = calibrators.marginalize_intervals_folds

    def marginalize_intervals_folds(cals, slices, *args, **kwargs):
        outs = folds(cals, slices, *args, **kwargs)
        altered = []
        for out in outs:
            out = dict(out)
            out['T'] = out['T'] * 1.1
            altered.append(out)
        return altered
    calibrators.marginalize_intervals_folds = marginalize_intervals_folds


FAULTS = {'covariant_half': covariant_half, 'covariant_alter': covariant_alter,
          'folds_alter': folds_alter}


def register():
    """Make these faults modes of perfbench/control.py."""
    from perfbench import faults
    faults.FAULTS.update(FAULTS)


def main(argv=None) -> int:
    register()
    from perfbench import control
    return control.main(argv)


if __name__ == '__main__':
    sys.exit(main())
