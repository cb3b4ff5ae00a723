"""Entry points: one forward step, and a dry run of the multi-device paths.

Counterpart of ``__graft_entry__.py``.

``entry()``            -> (fn, example_args): the forward step of the flagship
                          model (variant multi-output ARD-RBF GP: per-output
                          LML and the posterior at the first training inputs).
``dryrun_multichip(n)`` -> run the mesh paths once over n ranks, tiny shapes:
                          in the caller's process group of n ranks, or in n
                          spawned ranks (gloo on the CPU; NCCL where n cards
                          are visible).

    python -m romcomma_tpu_torch.graft_entry [n]
"""

from __future__ import annotations

import sys

import numpy as np


def _example(N: int = 64, M: int = 4, L: int = 2):
    import torch
    from romcomma_tpu_torch.base.definitions import TORCH_FLOAT, device
    from romcomma_tpu_torch.models.params import variant_init
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(N, M)), dtype=TORCH_FLOAT(), device=device())
    y = torch.as_tensor(rng.normal(size=(N, L)), dtype=TORCH_FLOAT(), device=device())
    raw = variant_init(np.full(L, 2.0), np.full((L, M), 5.0), np.full(L, 0.05))
    return raw, x, y


def entry():
    """The forward step: per-output LML plus posterior prediction at the
    first 8 training inputs of the flagship variant MOGP."""
    from romcomma_tpu_torch.models import gp

    def forward(raw, x, y):
        lml = gp.lml_variant(raw, x, y)
        mean, var = gp.predict_variant(raw, x, y, x[:8])
        return lml, mean, var

    return forward, _example()


def _dryrun(rank: int, n_devices: int) -> float:
    """The mesh paths on this rank: the ('l', 'n') training step in the
    working dtype, then the ('n',) engines' LML and gradient (float64, so the
    two engines agree to 1e-6 whatever the working dtype), the GSA with
    errors over the mesh, and one value and (F, noise_cov) gradient of the
    covariant chain (``DistributedCovariantGP``). Returns the LML of the
    'cyclic' engine."""
    import torch
    from romcomma_tpu_torch.parallel import distributed as dist
    from romcomma_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(n_devices)
    L, N = max(2, mesh.size(0)), 16 * mesh.size(1)
    raw, x, y = _example(N=N, M=4, L=L)
    loss, grads = pmesh.training_step_sharded(mesh)(*pmesh.shard_data(mesh, raw, x, y), N)
    assert bool(torch.isfinite(loss)), 'sharded training step produced a non-finite loss'
    assert all(bool(torch.isfinite(g).all()) for g in grads.values()), \
        'sharded training step produced a non-finite gradient'

    n_mesh = dist.make_n_mesh(n_devices)
    rng = np.random.default_rng(1)
    N2, M2 = 8 * n_devices + 3, 4                 # deliberately off block boundaries
    X = rng.normal(size=(N2, M2))
    Y = np.sin(X[:, :1]) + 0.05 * rng.normal(size=(N2, 1))
    values = {}
    for engine in ('cyclic', 'cyclic2'):
        dgp = dist.DistributedGP(N2, n_mesh, block=8, dtype=np.float64, engine=engine)
        x_dev, y_dev = dgp.stage(X, Y)
        ls = torch.full((M2,), 1.5, dtype=x_dev.dtype, device=x_dev.device, requires_grad=True)
        value = dgp.lml(ls, 1.0, 0.05, x_dev, y_dev)
        (grad,) = torch.autograd.grad(value, ls)
        assert bool(torch.isfinite(value)) and bool(torch.isfinite(grad).all()), \
            f'the {engine} engine produced a non-finite LML or gradient'
        values[engine] = float(value.detach())
        if engine == 'cyclic':
            out = dgp.sobol_indices(ls.detach(), 1.0, 0.05, x_dev, y_dev, X,
                                    kind=('first_order', 'total'), error=True)
            for kind in ('first_order', 'total'):
                assert all(np.isfinite(v) for v in out['S'][kind].values()), \
                    'the mesh GSA produced a non-finite S'
                assert all(np.isfinite(v) for v in out['T'][kind].values()), \
                    'the mesh GSA produced a non-finite T'
    assert abs(values['cyclic2'] - values['cyclic']) <= 1e-6 * max(1.0, abs(values['cyclic'])), \
        f'the deferred engine LML disagrees with the block-cyclic engine: {values}'

    from romcomma_tpu_torch.parallel.covariant_mesh import DistributedCovariantGP
    Lc = 2
    Yc = np.concatenate([Y, 0.5 * Y + 0.05 * rng.normal(size=Y.shape)], axis=1)
    dgc = DistributedCovariantGP(N2, Lc, n_mesh, block=8, dtype=np.float64)
    st = dgc.stage(X, Yc, np.full((Lc, M2), 1.2))
    F, noise_cov = (torch.tensor(a, dtype=torch.float64, device=st.u.device, requires_grad=True)
                    for a in (np.eye(Lc) + 0.1, 0.05 * np.eye(Lc)))
    value = dgc.lml_fn(st)(F, noise_cov)
    dF, dnoise = torch.autograd.grad(value, (F, noise_cov))
    assert bool(torch.isfinite(value)), 'the covariant mesh produced a non-finite LML'
    assert bool(torch.isfinite(dF).all()) and bool(torch.isfinite(dnoise).all()), \
        'the covariant mesh produced a non-finite gradient'
    return values['cyclic']


def dryrun_multichip(n_devices: int) -> None:
    """The mesh paths once over n ranks, with tiny shapes: in the caller's
    process group (which must have n ranks), or in n spawned ranks."""
    import torch
    from romcomma_tpu_torch.base.definitions import group_size, in_process_group
    if in_process_group():
        if group_size() != n_devices:
            raise ValueError(f'dryrun_multichip({n_devices}) in a process group of '
                             f'{group_size()} ranks.')
        _dryrun(0, n_devices)
        return
    from romcomma_tpu_torch.parallel import spawn
    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    spawn.run(_dryrun, n_devices, n_devices, backend='nccl' if on_cards else 'gloo')


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
