"""Mean functions for the GP prior (reference: romcomma/gpf/mean_functions.py).
Counterpart of ``romcomma_tpu/models/means.py``.

The reference's ``MOMeanFunction`` defaults to ``Zero``, and every model the
reference constructs uses that default (gpf/models.py:127). The GP core
(models.gp) is written against the Zero prior mean; a non-zero mean composes
through ``GPR(..., mean_function=...)`` (models/gpr.py): the GP fits the
residuals ``Y - mean(X)`` and predictions add the mean back.
"""

from __future__ import annotations

import torch


class Zero:
    """Zero prior mean over L outputs (the reference default)."""

    def __init__(self, L: int = 1):
        self.L = L

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((x.shape[0], self.L), dtype=x.dtype, device=x.device)


class Constant:
    """Constant prior mean c (L,) per output."""

    def __init__(self, c) -> None:
        self.c = torch.atleast_1d(torch.as_tensor(c))
        self.L = self.c.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.broadcast_to(self.c[None, :].to(x), (x.shape[0], self.L))


class Linear:
    """Affine prior mean A^T x + b: A (M,L), b (L,)."""

    def __init__(self, A, b) -> None:
        self.A = torch.atleast_2d(torch.as_tensor(A))
        self.b = torch.atleast_1d(torch.as_tensor(b))
        self.L = self.b.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.A.to(x) + self.b[None, :].to(x)
