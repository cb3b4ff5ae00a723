"""Faults planted in the program underneath a run, to show that the
comparison which decides ``correct`` catches them (perfbench/control.py on
the card, perfbench/tests/test_faults.py on the CPU). Each fault patches the
port for the rest of the process; none is used by a benchmark run.

  - unchanged: every descent returns its start after one evaluation there
    (a step that returns its state unchanged);
  - half: half of the batch left out: in a fold group the second half of
    the members' LMLs replaced by the mean of the first half's; in one GP's
    LML the second half of the rows' outputs dropped; in the Sobol' pass the
    second half of K^-1 y handed to the calibrator dropped;
  - alter: an answer altered where it is produced: the LML of the batch's
    first member, or of the one GP, off by 1 %; the Sobol' pass's T of its
    first slice off by 10 %.

'unchanged' has nothing to act on in a Sobol' pass, which steps no state."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def unchanged():
    from scipy.optimize import OptimizeResult
    from romcomma_tpu_torch.ops import lbfgs

    def descent(value_and_grad, x0, *args, **kwargs):
        value_and_grad(x0)
        return OptimizeResult(x=x0, success=True, nit=0, message='unchanged'), False
    lbfgs._descent = descent


def half():
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.models import gp
    from romcomma_tpu_torch.parallel import distributed

    exact = gp.ExactLML.apply

    def exact_half(ls, s2, noise, x, y):
        values = exact(ls, s2, noise, x, y)
        if values.dim() == 0 or values.shape[0] < 2:
            return values
        h = values.shape[0] // 2
        return torch.cat([values[:h], values[:h].mean().expand(values.shape[0] - h)])

    class ExactHalf(gp.ExactLML):
        apply = staticmethod(exact_half)
    gp.ExactLML = ExactHalf

    mesh = distributed.MeshLML.apply

    def mesh_half(ls, s2, noise, x, y, *rest):
        y = y.clone()
        y[y.shape[0] // 2:] = 0.0
        return mesh(ls, s2, noise, x, y, *rest)

    class MeshHalf(distributed.MeshLML):
        apply = staticmethod(mesh_half)
    distributed.MeshLML = MeshHalf

    _wrap_from_arrays(calibrators, lambda K_inv_Y: _zero_second_half(K_inv_Y))


def alter():
    from romcomma_tpu_torch.gsa import calibrators
    from romcomma_tpu_torch.models import gp
    from romcomma_tpu_torch.parallel import distributed

    exact = gp.ExactLML.apply

    def exact_altered(ls, s2, noise, x, y):
        values = exact(ls, s2, noise, x, y)
        if values.dim() == 0:
            return values * 1.01
        return torch.cat([values[:1] * 1.01, values[1:]])

    class ExactAltered(gp.ExactLML):
        apply = staticmethod(exact_altered)
    gp.ExactLML = ExactAltered

    mesh = distributed.MeshLML.apply

    class MeshAltered(distributed.MeshLML):
        apply = staticmethod(lambda *args: mesh(*args) * 1.01)
    distributed.MeshLML = MeshAltered

    cls = calibrators.ClosedSobolWithError
    intervals = cls.marginalize_intervals

    def marginalize_intervals(self, slices):
        out = dict(intervals(self, slices))
        T = out['T'].clone()
        T[..., 1] *= 1.1
        out['T'] = T
        return out
    cls.marginalize_intervals = marginalize_intervals


def _zero_second_half(t: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(t).clone()
    t[..., t.shape[-1] // 2:] = 0.0
    return t


def _wrap_from_arrays(calibrators, change: Callable):
    cls = calibrators.ClosedSobolWithError
    original = cls.from_arrays.__func__

    def from_arrays(klass, *args, **kwargs):
        kwargs['K_inv_Y'] = change(kwargs['K_inv_Y'])
        return original(klass, *args, **kwargs)
    cls.from_arrays = classmethod(from_arrays)


FAULTS: Dict[str, Callable[[], None]] = {'unchanged': unchanged, 'half': half, 'alter': alter}
