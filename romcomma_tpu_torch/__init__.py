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
  - ``models``   the variant multi-output GP: LML, calibration, prediction,
                 posterior factors, and the persistent GPR/MOGP wrappers.
  - ``user``     run.gpr, sampling, test functions, results collection.

Not ported yet: covariant MOGP, the large-N route, GSA, ROM and the
multi-device engines.
"""

from romcomma_tpu_torch import base, data, ops, models, user  # noqa: F401

__version__ = '0.1.0'
