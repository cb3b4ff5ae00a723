"""L-BFGS-B minimization: scipy's Fortran L-BFGS-B, the reference's own
optimizer (gpr/models.py:359-361 via gpflow's Scipy wrapper), driving one
torch value-and-gradient per evaluation.

Counterpart of ``romcomma_tpu/ops/lbfgs.py::minimize_scipy``. ``minimize_lockstep``
runs many independent descents at once, each evaluation of them all one
batched call: the port's counterpart of romcomma_tpu's vmapped descents (its
optax L-BFGS over outputs and folds), keeping scipy's. Stopping rules are
scipy's:
  - maxiter      (reference META: 5000, gpr/models.py:330)
  - gtol         max|projected grad| <= gtol (reference META: 1e-16, never binding)
  - ftol         (f_prev - f) / max(|f_prev|, |f|, 1) <= ftol
                 (scipy's default 2.22e-9, the rule that ends the reference's runs)
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

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


class _Packing:
    """A dict of tensors <-> scipy's one float64 vector: unpacked tensors take
    the template's dtypes and device, so a float32 objective stays float32."""

    def __init__(self, params: Params):
        self.names = list(params)
        self.templates = [params[name].detach() for name in self.names]
        self.sizes = [t.numel() for t in self.templates]

    def x0(self) -> np.ndarray:
        return np.concatenate([t.to('cpu', torch.float64).numpy().ravel() for t in self.templates])

    def unpack(self, vector: np.ndarray) -> Params:
        out, offset = {}, 0
        for name, template, size in zip(self.names, self.templates, self.sizes):
            chunk = torch.from_numpy(np.ascontiguousarray(vector[offset:offset + size]))
            out[name] = chunk.reshape(template.shape).to(dtype=template.dtype,
                                                          device=template.device)
            offset += size
        return out

    def flat_grad(self, grads: Sequence[Optional[torch.Tensor]], rows: int) -> np.ndarray:
        """The gradients of ``names`` as one float64 vector per leading row:
        (rows, size) from leaves (rows, ...), zeros for an unused leaf."""
        return np.concatenate([np.zeros((rows, size)) if grad is None else
                               grad.detach().to('cpu', torch.float64).numpy().reshape(rows, -1)
                               for grad, size in zip(grads, self.sizes)], axis=1)


def _descent(value_and_grad: Callable[[np.ndarray], tuple], x0: np.ndarray, maxiter: int,
             gtol: float, ftol: float, memory_size: int, max_linesearch_steps: Optional[int]):
    """scipy's L-BFGS-B on ``value_and_grad(vector) -> (value, grad)``. A
    non-finite evaluation is reported to scipy as 1e100 with a zero gradient,
    so its line search backs off. Returns (scipy's result, whether the FIRST
    evaluation was non-finite)."""
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
    return sp_minimize(f, x0, jac=True, method='L-BFGS-B', options=options), \
        evaluations['first_nonfinite']


def _result(packing: _Packing, res, first_nonfinite: bool, value: float,
            g: np.ndarray) -> MinimizeResult:
    """The MinimizeResult of scipy's ``res``, with ``value`` and ``g`` a fresh
    evaluation at the returned point."""
    grad_norm = float(np.max(np.abs(g))) if np.all(np.isfinite(g)) else np.inf
    converged = bool(res.success) and not (first_nonfinite and res.nit == 0)
    message = res.message.decode() if isinstance(res.message, bytes) else str(res.message)
    return MinimizeResult(packing.unpack(res.x), value, grad_norm, int(res.nit), converged,
                          message)


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
    packing = _Packing(params)

    def value_and_grad(vector: np.ndarray):
        p = {name: t.requires_grad_(True) for name, t in packing.unpack(vector).items()}
        value = fun(p)
        grads = torch.autograd.grad(value, [p[name] for name in packing.names],
                                    allow_unused=True)
        return value.item(), packing.flat_grad([None if g is None else g[None] for g in grads],
                                               1)[0]

    res, first_nonfinite = _descent(value_and_grad, packing.x0(), maxiter, gtol, ftol,
                                    memory_size, max_linesearch_steps)
    return _result(packing, res, first_nonfinite, *value_and_grad(res.x))


class _Stopped(Exception):
    """Raised inside a descent's objective when the lockstep stops."""


def minimize_lockstep(fun: Callable[[List[int], Params], torch.Tensor], starts: Sequence[Params],
                      maxiter: int = 5000, gtol: float = 1e-16, ftol: float = SCIPY_FTOL,
                      memory_size: int = 30) -> List[MinimizeResult]:
    """Minimize len(starts) independent objectives, descent i from starts[i],
    each by its own scipy L-BFGS-B, in lockstep.

    ``fun(members, p)`` evaluates the objectives of the descents ``members``
    at once: p holds their points stacked on a leading axis (row r is descent
    members[r]'s), and it returns their values (len(members),), member r's
    depending on row r alone, so the gradient of their sum is each one's own.

    Each descent runs scipy in a thread of its own; its objective hands its
    point over and waits. Once every live descent has handed one in or
    returned, the calling thread makes ONE call of ``fun`` for them all and
    releases them; a descent that returns leaves the batch. So each descent
    keeps its own memory, line search, stopping rule and handling of
    non-finite values, and gives the descent ``minimize`` makes on its own.
    The fresh evaluation at the returned points is one call too. If a
    descent or ``fun`` raises, every descent is stopped and the error is
    raised here; no thread is left waiting. Returns one MinimizeResult per
    start, in order."""
    packings = [_Packing(start) for start in starts]
    names = packings[0].names
    lock = threading.Condition()
    points: Dict[int, np.ndarray] = {}
    answers: Dict[int, tuple] = {}
    state = {'live': len(starts), 'error': None}

    def evaluate(members: List[int], vectors: List[np.ndarray]):
        unpacked = [packings[i].unpack(vector) for i, vector in zip(members, vectors)]
        p = {name: torch.stack([u[name] for u in unpacked]).requires_grad_(True) for name in names}
        values = fun(members, p)
        grads = torch.autograd.grad(values.sum(), [p[name] for name in names], allow_unused=True)
        g = packings[0].flat_grad(grads, len(members))
        values = values.detach().to('cpu', torch.float64).numpy()
        return {i: (float(values[r]), g[r]) for r, i in enumerate(members)}

    def run(i: int, outcome: list):
        def value_and_grad(vector: np.ndarray):
            with lock:
                if state['error'] is not None:
                    raise _Stopped
                points[i] = vector
                lock.notify_all()
                while i not in answers and state['error'] is None:
                    lock.wait()
                if state['error'] is not None:
                    raise _Stopped
                return answers.pop(i)

        try:
            outcome.append(_descent(value_and_grad, packings[i].x0(), maxiter, gtol, ftol,
                                    memory_size, None))
        except _Stopped:
            pass
        except BaseException as error:       # the lockstep re-raises it
            with lock:
                if state['error'] is None:
                    state['error'] = error
        finally:
            with lock:
                state['live'] -= 1
                lock.notify_all()

    outcomes: List[list] = [[] for _ in starts]
    threads = [threading.Thread(target=run, args=(i, outcomes[i]), daemon=True)
               for i in range(len(starts))]
    for thread in threads:
        thread.start()
    try:
        while True:
            with lock:
                while state['error'] is None and state['live'] and len(points) < state['live']:
                    lock.wait()
                if state['error'] is not None or not state['live']:
                    break
                batch = dict(sorted(points.items()))
                points.clear()
            answered = evaluate(list(batch), list(batch.values()))
            with lock:
                answers.update(answered)
                lock.notify_all()
    except BaseException as error:
        with lock:
            if state['error'] is None:
                state['error'] = error
            lock.notify_all()
    finally:
        for thread in threads:
            thread.join()
    if state['error'] is not None:
        raise state['error']
    finals = evaluate(list(range(len(starts))), [outcome[0][0].x for outcome in outcomes])
    return [_result(packings[i], res, first_nonfinite, *finals[i])
            for i, ((res, first_nonfinite),) in enumerate(outcomes)]
