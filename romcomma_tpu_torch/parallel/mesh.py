"""Meshes of ranks for the variant training step and for folds.

Counterpart of ``romcomma_tpu/parallel/mesh.py``. romcomma_tpu jits its steps
with ``NamedSharding`` over a ('l', 'n') mesh and lets XLA insert the
collectives; here each rank of a process group holds its part and the
collectives are written out:

  - ``l``: the output axis. L independent GPs are embarrassingly parallel,
    so each 'l' coordinate takes a contiguous share of the outputs.
  - ``n``: the training-row axis. Each 'n' coordinate holds a contiguous
    share of the rows; the gram needs them all, so X (and the rank's outputs
    of Y) are all-gathered over 'n' and the LML is summed over 'l'.
  - ``k``: the fold axis (``make_fold_mesh``): each rank calibrates a
    contiguous share of the folds on its own, and the results are
    all-gathered.

Every function here needs an initialized process group
(``parallel.multihost.init``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from romcomma_tpu_torch.base.definitions import device as compute_device, in_process_group
from romcomma_tpu_torch.models import gp
from romcomma_tpu_torch.models.params import VariantParams

NO_GROUP = ('a mesh spans the ranks of a process group: initialize one first '
            '(parallel.multihost.init, under torchrun)')


def _world(n_devices: Optional[int]) -> int:
    import torch.distributed as dist
    if not in_process_group():
        raise ValueError(f'parallel.mesh: {NO_GROUP}.')
    S = dist.get_world_size()
    if n_devices not in (None, S):
        raise ValueError(f'parallel.mesh: n_devices={n_devices} in a process group of {S} ranks; '
                         f'a mesh spans every rank.')
    return S


def make_mesh(n_devices: Optional[int] = None, l_size: Optional[int] = None):
    """An ('l', 'n') DeviceMesh over the process group's ranks. ``l_size``
    divides their number; it defaults to the largest power of two <= sqrt(n)
    that does."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world(n_devices)
    if l_size is None:
        l_size = 1
        while l_size * 2 <= math.isqrt(n) and n % (l_size * 2) == 0:
            l_size *= 2
    if n % l_size != 0:
        raise ValueError(f'l_size={l_size} does not divide n_devices={n}.')
    return init_device_mesh(compute_device().type, (l_size, n // l_size),
                            mesh_dim_names=('l', 'n'))


def _share(total: int, parts: int, index: int) -> slice:
    """The index-th of ``parts`` contiguous shares of range(total), as
    NamedSharding lays out an axis (the last shares may be short or empty)."""
    size = -(-total // parts)
    return slice(min(index * size, total), min((index + 1) * size, total))


class VariantShards(NamedTuple):
    """This rank's part of the variant training step: its outputs (by its
    'l' coordinate) and its rows (by its 'n' coordinate)."""
    outputs: Callable[[int], slice]
    rows: Callable[[int], slice]


def variant_shardings(mesh) -> VariantShards:
    """Where the variant step's arrays live: parameters over outputs ('l'),
    data rows over 'n' (Y's columns over 'l' too)."""
    l_size, n_size = mesh.size(0), mesh.size(1)
    l_at, n_at = mesh.get_local_rank('l'), mesh.get_local_rank('n')
    return VariantShards(outputs=lambda L: _share(L, l_size, l_at),
                         rows=lambda N: _share(N, n_size, n_at))


def shard_data(mesh, raw: VariantParams, x: torch.Tensor, y: torch.Tensor
               ) -> Tuple[VariantParams, torch.Tensor, torch.Tensor]:
    """This rank's part of (params (L, ...), x (N, M), y (N, L)) under the
    variant shardings, on its device."""
    shards = variant_shardings(mesh)
    outputs, rows = shards.outputs(y.shape[1]), shards.rows(x.shape[0])
    on = compute_device()
    return ({name: value[outputs].to(on) for name, value in raw.items()},
            x[rows].to(on), y[rows, outputs].to(on))


def _gather_rows(mesh, t: torch.Tensor, N: int) -> torch.Tensor:
    """The (N, ...) array whose rows the 'n' axis shares out, from this
    rank's share: one all_gather over 'n' of shares padded to equal size."""
    import torch.distributed as dist
    n_size = mesh.size(1)
    size = -(-N // n_size)
    padded = torch.zeros((size,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    padded[:t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(n_size)]
    dist.all_gather(parts, padded, group=mesh.get_group('n'))
    return torch.cat(parts)[:N]


def training_step_sharded(mesh) -> Callable:
    """One training step (value and gradient of minus the summed variant
    LML) over the ('l', 'n') mesh: fn(raw, x, y, N) with this rank's shards
    (``shard_data``) and the full row count N -> (loss, gradient of this
    rank's parameters). X and this rank's outputs of Y are all-gathered over
    'n', each rank takes the LMLs of its outputs, and the loss is summed over
    'l': it equals -sum(gp.lml_variant) on every rank."""
    import torch.distributed as dist

    def step(raw: VariantParams, x: torch.Tensor, y: torch.Tensor, N: int):
        x_all, y_all = _gather_rows(mesh, x, N), _gather_rows(mesh, y, N)
        p = {name: value.detach().requires_grad_(True) for name, value in raw.items()}
        loss = (-torch.sum(gp.lml_variant(p, x_all, y_all)) if y_all.shape[1] else
                torch.zeros((), dtype=x.dtype, device=x.device, requires_grad=True))
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
        total = loss.detach().clone()
        dist.all_reduce(total, group=mesh.get_group('l'))
        return total, grads

    return step


def make_fold_mesh(n_devices: Optional[int] = None):
    """A 1-D ('k',) DeviceMesh over the process group's ranks, for folds."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(compute_device().type, (_world(n_devices),),
                            mesh_dim_names=('k',))


def calibrate_folds_sharded(mesh, maxiter: int = 5000) -> Callable:
    """Fold-sharded variant calibration over a ('k',) mesh: each rank runs
    ``gp.calibrate_variant_folds`` on its contiguous share of the K folds, on
    its own (no collective during the descents); the results are
    all-gathered. Returns fn(raws (K, L, ...), mask, xs (K, N, M), ys
    (K, N, L)) -> (raw_opt (K, L, ...), lml (K, L), iterations (K, L)), the
    same on every rank."""
    import torch.distributed as dist

    def run(raws: VariantParams, mask, xs: torch.Tensor, ys: torch.Tensor):
        folds = _share(xs.shape[0], mesh.size(), mesh.get_local_rank())
        on = compute_device()
        mine = None
        if folds.stop > folds.start:
            raw_opt, lml, iterations, _ = gp.calibrate_variant_folds(
                {name: value[folds].to(on) for name, value in raws.items()}, mask,
                xs[folds].to(on), ys[folds].to(on), maxiter=maxiter)
            mine = ({name: value.detach().cpu() for name, value in raw_opt.items()},
                    lml.cpu(), iterations.cpu())
        shares = [None] * mesh.size()
        dist.all_gather_object(shares, mine, group=mesh.get_group())
        shares = [share for share in shares if share is not None]
        return ({name: torch.cat([share[0][name] for share in shares]) for name in raws},
                torch.cat([share[1] for share in shares]),
                torch.cat([share[2] for share in shares]))

    return run
