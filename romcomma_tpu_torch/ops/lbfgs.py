"""L-BFGS-B minimization: scipy's Fortran L-BFGS-B, the reference's own
optimizer (gpr/models.py:359-361 via gpflow's Scipy wrapper), driving one
torch value-and-gradient per evaluation.

Counterpart of ``romcomma_tpu/ops/lbfgs.py::minimize_scipy``. Stopping rules
are scipy's:
  - maxiter      (reference META: 5000, gpr/models.py:330)
  - gtol         max|projected grad| <= gtol (reference META: 1e-16, never binding)
  - ftol         (f_prev - f) / max(|f_prev|, |f|, 1) <= ftol
                 (scipy's default 2.22e-9, the rule that ends the reference's runs)
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from scipy.optimize import minimize as sp_minimize

#: scipy's default ftol for L-BFGS-B = 2.220446049250313e-09.
SCIPY_FTOL = 2.220446049250313e-09

Params = Dict[str, torch.Tensor]


class MinimizeResult(NamedTuple):
    params: Params
    value: float
    grad_norm: float
    iterations: int
    converged: bool    # True if scipy stopped on ftol/gtol rather than maxiter
    message: str       # scipy's reason for stopping


def minimize(fun: Callable[[Params], torch.Tensor], params: Params, maxiter: int = 5000,
             gtol: float = 1e-16, ftol: float = SCIPY_FTOL, memory_size: int = 30,
             max_linesearch_steps: Optional[int] = None) -> MinimizeResult:
    """Minimize the scalar ``fun(params)`` over a dict of tensors.

    scipy works on one float64 vector; every evaluation unpacks it into
    tensors of the initial params' dtypes and device, so a float32 objective
    stays float32. A non-finite evaluation is reported to scipy as 1e100 with
    a zero gradient, so its line search backs off. The returned value is a
    fresh evaluation at the returned params, so callers' isfinite checks
    still see a breakdown there.

    ``max_linesearch_steps`` becomes scipy's ``maxls`` (None keeps scipy's
    default of 20)."""
    names = list(params)
    templates = [params[name].detach() for name in names]
    sizes = [t.numel() for t in templates]

    def unpack(vector: np.ndarray) -> Params:
        out, offset = {}, 0
        for name, template, size in zip(names, templates, sizes):
            chunk = torch.from_numpy(np.ascontiguousarray(vector[offset:offset + size]))
            out[name] = chunk.reshape(template.shape).to(dtype=template.dtype,
                                                          device=template.device)
            offset += size
        return out

    def value_and_grad(vector: np.ndarray):
        p = {name: t.requires_grad_(True) for name, t in unpack(vector).items()}
        value = fun(p)
        grads = torch.autograd.grad(value, [p[name] for name in names], allow_unused=True)
        g = np.concatenate([np.zeros(size) if grad is None else
                            grad.detach().to('cpu', torch.float64).numpy().ravel()
                            for grad, size in zip(grads, sizes)])
        return value.item(), g

    evaluations = {'count': 0, 'first_nonfinite': False}

    def f(vector: np.ndarray):
        value, g = value_and_grad(vector)
        evaluations['count'] += 1
        if not (np.isfinite(value) and np.all(np.isfinite(g))):
            # A non-finite FIRST evaluation makes L-BFGS-B see a zero
            # projected gradient and "converge" at x0: flag it, so the
            # returned converged field tells the truth.
            if evaluations['count'] == 1:
                evaluations['first_nonfinite'] = True
            return 1e100, np.zeros_like(g)
        return value, g

    options = {'maxiter': maxiter, 'ftol': ftol, 'gtol': gtol, 'maxcor': memory_size}
    if max_linesearch_steps:
        options['maxls'] = int(max_linesearch_steps)
    x0 = np.concatenate([t.to('cpu', torch.float64).numpy().ravel() for t in templates])
    res = sp_minimize(f, x0, jac=True, method='L-BFGS-B', options=options)
    value, g = value_and_grad(res.x)
    grad_norm = float(np.max(np.abs(g))) if np.all(np.isfinite(g)) else np.inf
    converged = bool(res.success) and not (evaluations['first_nonfinite'] and res.nit == 0)
    message = res.message.decode() if isinstance(res.message, bytes) else str(res.message)
    return MinimizeResult(unpack(res.x), value, grad_norm, int(res.nit), converged, message)
