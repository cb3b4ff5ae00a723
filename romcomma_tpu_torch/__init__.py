"""romcomma_tpu_torch — the PyTorch/CUDA port of romcomma_tpu, for NVIDIA
Hopper GPUs: Reduced Order Modelling via Global Sensitivity Analysis using
Gaussian Process Regression.

It mirrors romcomma_tpu's layout and public names and reads and writes the
same CSV + meta.json tree:
  - ``base``     dtype policy (ROMCOMMA_X64), reference floors, the compute
                 device, and the persistent Frame/Data/Model classes.
  - ``data``     Repository/Fold/Normalization persistence (pandas).
  - ``ops``      ARD-RBF grams (plain torch, and the hand-written CUDA
                 unit-gram kernel in ``csrc/unit_gram.cu``), Cholesky and
                 triangular solves, scipy L-BFGS-B on a torch objective.
  - ``models``   the variant and covariant multi-output GPs: LML,
                 calibration, prediction, posterior factors, the
                 persistent GPR/MOGP wrappers, and the likelihood layer
                 (Gauss-Hermite quadrature, MOGaussian).
  - ``parallel`` the large-N variant route: a one-device DistributedGP.
  - ``gsa``      closed-form Sobol' indices with standard errors, in float64:
                 the calibrators (the rotated-basis one included), their
                 factorized interval and error sweeps, and the persistent
                 Sobol models.
  - ``rom``      Reduced Order Modelling: the alternating input-basis
                 rotation loop (active subspace or leading Sobol' index).
  - ``user``     run.gpr, run.gsa, run.rom (the equal-shape folds of a
                 repository batched by default), sampling and its CLI, test
                 functions, results collection and copy, GLS regression.

The entry points: ``csv_script`` (a user's CSV through k-fold GPR and GSA)
and ``benchmark_script`` (the M x N x noise sweep), the ports of the
repository's root scripts; ``installation_test``; ``north_star`` runs the
N=20000, M=30 north-star workload on the card, and ``rom_scale`` the N=8192,
M=10 planted-subspace ROM.

Not ported yet: the large route's output-stacked GSA (its indices come from
a loop over outputs) and the multi-device engines.
"""

from romcomma_tpu_torch import base, data, ops, models, gsa, parallel, rom, user  # noqa: F401

__version__ = '0.1.0'
