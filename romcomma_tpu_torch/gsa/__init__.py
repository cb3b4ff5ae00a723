"""Closed-form Sobol' global sensitivity analysis of a trained GP: the Gaussian
algebra, the calibrators with their factorized interval and error sweeps, and
the persistent GSA models."""
from romcomma_tpu_torch.gsa import base, calibrators, factorized_errors, models  # noqa: F401
