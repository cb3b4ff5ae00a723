"""Rank bodies of the port's mesh tests: each runs on one rank of a fresh gloo
group (``romcomma_tpu_torch.parallel.spawn.run``), on the CPU, and returns
numpy results to the test process. This module imports no JAX: the ranks
never load it. Not collected by pytest (no ``test_`` prefix)."""

from __future__ import annotations

import fcntl
import pickle
from pathlib import Path

import numpy as np
import torch

#: The mesh problem: N not divisible by B S, so padding rows are live.
N, M, B = 300, 4, 32
ENGINES = ('cyclic', 'cyclic2')
KINDS = ('first_order', 'total')
#: Chunk of the GSA sweeps: several chunks, spread over the ranks.
N_CHUNK = 64


def problem():
    """(X, Y, Xs, (ls, s2, noise)) from a seed."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-1, 1, (N, M))
    Y = np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2 + 0.1 * rng.normal(size=(N, 1))
    return X, Y, rng.uniform(-1, 1, (9, M)), (rng.uniform(0.5, 1.2, M), 1.3, 0.05)


def run_once(folder: Path, name: str, compute):
    """compute()'s result, computed once for all the test processes that ask
    under ``folder`` (one per test run, shared by pytest-xdist's workers), so
    that two test files share one spawn of ranks: the first to ask computes
    it and keeps it there; the others wait for it and read it."""
    folder.mkdir(parents=True, exist_ok=True)
    data = folder / f'{name}.pickle'
    with open(folder / f'{name}.lock', 'a') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if data.exists():
            return pickle.loads(data.read_bytes())
        result = compute()
        data.write_bytes(pickle.dumps(result))
        return result


def _gathered(ring, local: torch.Tensor) -> np.ndarray:
    """Every rank's rows, in stored order."""
    return ring.gather(local).reshape(-1, local.shape[-1]).numpy()


def engines(rank: int, super_block=None, maxiter: int = 6) -> dict:
    """Per engine on this mesh: the gram, the factor (and for 'cyclic2' its
    inverse) gathered in stored row order, the log-det and alpha from the
    engine's solves; the LML and its gradient; the float64 posterior alpha
    and predictions; the indices of two kinds with T; a short calibrate
    with every point it evaluated; and the float32 engine's LML and
    gradient beside its own float32 gram, factor, solves and reductions
    (``float32``)."""
    from romcomma_tpu_torch.parallel import distributed as dist
    from romcomma_tpu_torch.parallel.cyclic_deferred import DeferredEngine
    X, Y, Xs, hypers = problem()
    out = {}
    for engine in ENGINES:
        gp = dist.DistributedGP(N, dist.make_n_mesh(), block=B, dtype=np.float64, engine=engine)
        if super_block is not None and engine == 'cyclic2':
            gp._ops = DeferredEngine(gp.plan, gp.mesh, super_block)
        ops, ring = gp._ops, gp._ops.ring
        x, y = gp.stage(X, Y)
        ls, s2, noise = (torch.as_tensor(np.asarray(h, dtype=np.float64)) for h in hypers)
        K = ops.gram(x, ls, s2, noise)
        result = {'gram': _gathered(ring, K)}
        F = ops.chol(K)
        result['factor'] = _gathered(ring, F)
        result['logdet'] = 2.0 * float(ops.logdiag(F))
        result['alpha'] = dist.from_stored(gp.plan, ops.bwd(F, ops.fwd(F, y)).numpy())
        if engine == 'cyclic2':
            result['inverse'] = _gathered(ring, ops.inv(F))
        p = [torch.tensor(np.asarray(h, dtype=np.float64), requires_grad=True) for h in hypers]
        value = gp.lml(*p, x, y)
        result['lml'] = float(value.detach())
        result['grad'] = np.concatenate([g.reshape(-1).numpy()
                                         for g in torch.autograd.grad(value, p)])
        alpha, _ = gp.posterior_alpha(*hypers, x, y)
        result['posterior'] = dist.from_stored(gp.plan, alpha.numpy())
        result['mean'], result['var'] = (t.numpy() for t in gp.predict(*hypers, x, y, Xs))
        result['sobol'] = gp.sobol_indices(hypers[0], hypers[1], hypers[2], x, y, X, kind=KINDS,
                                           error=True, is_T_partial=False, n_chunk=N_CHUNK)
        seen, lml = [], gp.lml

        def recording(*args):
            seen.append(b''.join(t.detach().numpy().tobytes() for t in args[:3]))
            return lml(*args)

        gp.lml = recording
        (ls_opt, s2_opt, noise_opt), lml_opt, iterations = gp.calibrate(
            X, Y, np.full(M, 1.0), 1.0, 0.1, maxiter=maxiter)
        result['calibrate'] = (seen, [t.numpy() for t in (ls_opt, s2_opt, noise_opt)],
                               float(lml_opt), iterations)
        result['float32'] = _float32_steps(engine, super_block, X, Y, hypers)
        if rank:                                    # only rank 0 sends the big arrays
            for key in ('gram', 'factor', 'inverse'):
                result.pop(key, None)
        out[engine] = result
    return out


def _float32_steps(engine: str, super_block, X, Y, hypers) -> tuple:
    """(the float32 engine's LML dtype, its LML and gradient through
    ``DistributedGP.lml``, the same from the engine's float32 steps: gram,
    factor, solves, log-det, residual and reductions)."""
    import math

    from romcomma_tpu_torch.parallel import distributed as dist
    from romcomma_tpu_torch.parallel.cyclic_deferred import DeferredEngine
    gp = dist.DistributedGP(N, dist.make_n_mesh(), block=B, dtype=np.float32, engine=engine)
    if super_block is not None and engine == 'cyclic2':
        gp._ops = DeferredEngine(gp.plan, gp.mesh, super_block)
    ops = gp._ops
    x, y = gp.stage(X, Y)
    p = [torch.tensor(np.asarray(h, dtype=np.float32), requires_grad=True) for h in hypers]
    value = gp.lml(*p, x, y)
    through = [value.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(value, p)]
    at = [t.detach() for t in p]
    F = ops.chol(ops.gram(x, *at))
    z = ops.fwd(F, y)
    alpha = ops.bwd(F, z)
    steps = -0.5 * torch.sum(z * z) - ops.logdiag(F) - 0.5 * N * math.log(2.0 * math.pi)
    grads = ops.grads(ops.residual(F), alpha, x, *at)
    return (str(value.dtype), through, [steps.numpy()] + [g.numpy() for g in grads])


def mesh_suite(rank: int, q: int, arrays: dict, slices: tuple) -> dict:
    """On this group of S ranks: engines(), deferred(q S B), sweeps(arrays,
    slices) and covariant(q S COV_B), in one spawn."""
    import torch.distributed as dist
    S = dist.get_world_size()
    return {'engines': engines(rank), 'deferred': deferred(rank, q * S * B),
            'sweeps': sweeps(rank, arrays, slices), 'covariant': covariant(rank, q * S * COV_B)}


#: The covariant mesh problem: L N = 75 rows over blocks of COV_B, so the
#: plan has c = 5, 4, 3 blocks per rank at S = 2, 3, 4 (padding rows live),
#: and F and the noise covariance non-diagonal.
COV_N, COV_M, COV_L, COV_B = 25, 3, 3, 8
COV_MAXITER = 25


def covariant_problem():
    """(X, Y, lengthscales (L, M), F, noise_cov) from a seed."""
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (COV_N, COV_M))
    Y = np.stack([np.sin(2 * X[:, 0]), X[:, 1] ** 2, X[:, 2] - X[:, 0] * X[:, 1]], axis=-1)
    Y = Y + 0.05 * rng.standard_normal((COV_N, COV_L))
    ls = np.array([[0.9, 0.8, 1.1], [0.7, 1.0, 0.9], [1.2, 0.9, 0.8]])
    F = np.array([[1.0, 0.3, -0.2], [0.3, 0.8, 0.1], [-0.2, 0.1, 0.9]])
    noise_cov = np.array([[0.05, 0.01, 0.0], [0.01, 0.04, -0.005], [0.0, -0.005, 0.06]])
    return X, Y, ls, F, noise_cov


def covariant(rank: int, super_block: int) -> dict:
    """parallel.covariant_mesh on this mesh, float64, at ``super_block``: the
    gram (stored rows; rank 0 sends it), the LML and its (F, noise_cov)
    gradient, the LML without a gradient, and a descent of COV_MAXITER
    iterations from (F, noise_cov) with F's off-diagonals trained, with
    every point it evaluated."""
    from romcomma_tpu_torch.models.params import covariant_init, covariant_mask
    from romcomma_tpu_torch.parallel import covariant_mesh
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    X, Y, ls, F, noise_cov = covariant_problem()
    gp = covariant_mesh.DistributedCovariantGP(COV_N, COV_L, make_n_mesh(), block=COV_B,
                                               dtype=np.float64, super_block=super_block)
    st = gp.stage(X, Y, ls)
    p = [torch.tensor(a, requires_grad=True) for a in (F, noise_cov)]
    out = {'q': gp.engine.q, 'c': gp.plan.c,
           'gram': _gathered(gp.engine.ring, gp._gram(st, *(t.detach() for t in p)))}
    if rank:                                        # only rank 0 sends the big array
        out.pop('gram')
    lml = gp.lml_fn(st)
    value = lml(*p)
    out['lml'] = float(value.detach())
    out['grad'] = [g.numpy() for g in torch.autograd.grad(value, p)]
    with torch.no_grad():
        out['lml, no gradient'] = float(lml(*p))
    seen, original = [], gp.lml_fn

    def recording(st_):
        fn = original(st_)

        def lml_(F_, noise_):
            seen.append(F_.detach().numpy().tobytes() + noise_.detach().numpy().tobytes())
            return fn(F_, noise_)

        return lml_

    gp.lml_fn = recording
    raw = covariant_init(F, ls, noise_cov, on=torch.device('cpu'))
    raw_opt, lml_opt, iterations, stop = gp.calibrate(
        X, Y, raw, covariant_mask(kernel_covariance=True), maxiter=COV_MAXITER)
    out['calibrate'] = (seen, {k: v.numpy() for k, v in raw_opt.items()}, float(lml_opt),
                        iterations, stop)
    return out


def two_rank_suite(rank: int, multihost_root: str, run_gpr_root: str, sweep_root: str,
                   step: tuple, folds: tuple, star: tuple, covariant_roots: tuple) -> dict:
    """The two-rank cases in one spawn: multihost_tree, run_gpr (threshold
    50), sweep, sharded_step on a 1 x 2 mesh, folds_sharded, north_star,
    covariant_routing, and graft_entry.dryrun_multichip(2) (its covariant
    step included) in this group."""
    from romcomma_tpu_torch import graft_entry
    out = {'multihost': multihost_tree(rank, multihost_root),
           'run_gpr': run_gpr(rank, run_gpr_root, 50), 'sweep': sweep(rank, sweep_root),
           'step': sharded_step(rank, *step, 1), 'folds': folds_sharded(rank, *folds),
           'north_star': north_star(rank, *star),
           'covariant': covariant_routing(rank, *covariant_roots)}
    graft_entry.dryrun_multichip(2)
    return out


def deferred(rank: int, super_block: int) -> dict:
    """cyclic_deferred's pieces at ``super_block``: gram, factor, inverse
    (gathered, stored rows), log-det, alpha through the stored-order solves,
    and the ring pair-tile gradient, unscaled."""
    from romcomma_tpu_torch.parallel import cyclic_deferred as cd
    from romcomma_tpu_torch.parallel import distributed as dist
    X, Y, _, (ls, s2, noise) = problem()
    mesh = dist.make_n_mesh()
    pl = dist.plan(N, mesh.size(), B)
    engine = cd.DeferredEngine(pl, mesh, super_block)
    x = torch.as_tensor(dist.to_stored(pl, X))
    y = torch.as_tensor(dist.to_stored(pl, Y))
    ls, s2, noise = (torch.as_tensor(np.asarray(h, dtype=np.float64)) for h in (ls, s2, noise))
    U = engine.chol(engine.gram(x, ls, s2, noise))
    out = {'q': engine.q, 'factor': _gathered(engine.ring, U),
           'logdet': 2.0 * float(engine.logdiag(U))}
    alpha = engine.bwd(U, engine.fwd(U, y))
    out['alpha'] = dist.from_stored(pl, alpha.numpy())
    V = engine.inv(U)
    out['inverse'] = _gathered(engine.ring, V)
    perm, inv = cd.stored_global_perms(pl)
    grads = cd.grads_ring_pairs(pl, mesh, super_block)(V, alpha[torch.as_tensor(inv)], x, ls,
                                                       s2, noise)
    out['grads'] = np.concatenate([g.reshape(-1).numpy() for g in grads])
    return out


def sweeps(rank: int, arrays: dict, slices: tuple) -> dict:
    """The error calibrator's factorized V pass and W/T sweep with its chunks
    over this mesh (``gsa_mesh``), from float64 arrays: V, S, W and T."""
    from romcomma_tpu_torch.gsa.calibrators import ClosedSobolWithError
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    cal = ClosedSobolWithError.from_arrays(**arrays, is_F_diagonal=True, L=1, M=M, N=N,
                                           n_chunk=N_CHUNK, is_T_partial=False)
    cal.gsa_mesh = make_n_mesh()
    out = cal.marginalize_intervals(slices)
    return {key: value.numpy() for key, value in out.items()}


def multihost_tree(rank: int, root: str) -> list:
    """parallel.multihost over this group: each rank trains its fold share
    alone, a barrier, then the collects (rank 0 writes)."""
    from romcomma_tpu_torch.data.storage import Repository
    from romcomma_tpu_torch.parallel import multihost
    repo = Repository(root)
    names = multihost.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=False,
                          maxiter=15)
    multihost.barrier()
    multihost.collect_gpr(names, repo)
    gsa = multihost.gsa('gpr', repo, is_covariant=False, is_isotropic=False,
                        is_error_calculated=True)
    multihost.barrier()
    multihost.collect_gsa(gsa, repo, is_error_calculated=True)
    return multihost.my_folds(repo)


def run_gpr(rank: int, root: str, threshold: int) -> list:
    """user.run.gpr and run.gsa over this group: every rank runs every fold;
    folds of ``threshold`` rows or more train over the mesh."""
    from romcomma_tpu_torch import user
    from romcomma_tpu_torch.data.storage import Repository
    from romcomma_tpu_torch.parallel.distributed import DistributedGP
    engines, original = [], DistributedGP.__init__

    def recorded(self, *args, **kwargs):
        original(self, *args, **kwargs)
        engines.append((self.N, self.engine))

    DistributedGP.__init__ = recorded
    try:
        repo = Repository(root)
        user.run.gpr('gpr', repo, is_read=False, is_covariant=False, is_isotropic=False,
                     maxiter=15, large_n_threshold=threshold)
        user.run.gsa('gpr', repo, is_covariant=False, is_isotropic=False,
                     is_error_calculated=True)
    finally:
        DistributedGP.__init__ = original
    return engines


#: The sweep's grid: two cells (noise 0.1, M = 7 and 9, N = 30), one a rank.
SWEEP_GRID = {'Ns': (30,), 'Ms': (7, 9), 'NOISE_MAGNITUDES': (0.1,)}


def sweep(rank: int, root: str) -> tuple:
    """benchmark_script's CLI over this group on SWEEP_GRID (-f -r -s): each
    rank samples, trains and analyses its own cell; rank 0 collects both at
    root. Returns the (process id, process count) the script took."""
    from romcomma_tpu_torch import benchmark_script
    for name, value in SWEEP_GRID.items():
        setattr(benchmark_script, name, value)
    benchmark_script.main(['-f', '-r', '-s', root])
    return benchmark_script.process_identity()


def sharded_step(rank: int, raw: dict, x: np.ndarray, y: np.ndarray, l_size: int) -> tuple:
    """parallel.mesh's training step on an ('l', 'n') mesh: the loss and
    this rank's (output slice, gradient)."""
    from romcomma_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(l_size=l_size)
    raw = {name: torch.as_tensor(value) for name, value in raw.items()}
    shards = pmesh.shard_data(mesh, raw, torch.as_tensor(x), torch.as_tensor(y))
    loss, grads = pmesh.training_step_sharded(mesh)(*shards, x.shape[0])
    outputs = pmesh.variant_shardings(mesh).outputs(y.shape[1])
    return float(loss), (outputs.start, outputs.stop), {k: g.numpy() for k, g in grads.items()}


def folds_sharded(rank: int, raws: dict, mask: dict, xs: np.ndarray, ys: np.ndarray) -> tuple:
    """parallel.mesh's fold-sharded calibration over a ('k',) mesh."""
    from romcomma_tpu_torch.parallel import mesh as pmesh
    run = pmesh.calibrate_folds_sharded(pmesh.make_fold_mesh(), maxiter=20)
    raw_opt, lml, iterations = run({name: torch.as_tensor(v) for name, v in raws.items()}, mask,
                                   torch.as_tensor(xs), torch.as_tensor(ys))
    return {k: v.numpy() for k, v in raw_opt.items()}, lml.numpy(), iterations.numpy()


def north_star(rank: int, N_: int, M_: int, maxiter: int) -> tuple:
    """romcomma_tpu_torch.north_star.run over this group's mesh, on the CPU:
    its engine and ranks, LML, iterations and indices."""
    from romcomma_tpu_torch import north_star as ns
    from romcomma_tpu_torch.parallel.distributed import make_n_mesh
    out, _ = ns.run(N_, M_, maxiter, on='cpu', mesh=make_n_mesh())
    return out['engine'], out['ranks'], out['lml'], out['iters'], out['S1_first3']


#: covariant_routing's lowered L*N from which a covariant descent takes the
#: mesh (covariant_mesh.COVARIANT_MESH_MIN_LN), and its large-N threshold
#: (meta['large_n_threshold']) where the route is to be large: the tiny
#: repository's improper fold (60 rows, 2 outputs: L N = 120) reaches both,
#: its other folds (L N = 60) neither.
COV_MESH_MIN_LN, COV_LARGE_N = 64, 100


def covariant_routing(rank: int, below_root: str, above_root: str) -> dict:
    """user.run.gpr's covariant pass over this group, with the covariant
    mesh's L*N threshold lowered to COV_MESH_MIN_LN in this process: on
    below_root at the default large-N threshold, on above_root at
    COV_LARGE_N. Returns, for each, the (N, L, ranks) of every
    DistributedCovariantGP it built; and what engine='upper' raises on
    several ranks."""
    from romcomma_tpu_torch import user
    from romcomma_tpu_torch.base.definitions import in_process_group
    from romcomma_tpu_torch.data.storage import Repository
    from romcomma_tpu_torch.parallel import covariant_mesh
    from romcomma_tpu_torch.parallel import distributed as dist
    cls, out = covariant_mesh.DistributedCovariantGP, {}
    original = (covariant_mesh.COVARIANT_MESH_MIN_LN, cls.__init__)

    def recorded(self, *args, **kwargs):
        original[1](self, *args, **kwargs)
        built.append((self.N, self.L, self.plan.S))

    covariant_mesh.COVARIANT_MESH_MIN_LN, cls.__init__ = COV_MESH_MIN_LN, recorded
    try:
        for key, root, meta in (('below', below_root, {}),
                                ('above', above_root, {'large_n_threshold': COV_LARGE_N})):
            built = out[key] = []
            user.run.gpr('gpr', Repository(root), is_read=False, is_covariant=True,
                         is_isotropic=False, maxiter=15, **meta)
    finally:
        covariant_mesh.COVARIANT_MESH_MIN_LN, cls.__init__ = original
    if in_process_group():
        try:
            dist.DistributedGP(10, dist.make_n_mesh(), engine='upper')
        except ValueError as error:
            out['upper'] = str(error)
    return out


def fails_on_rank_one(rank: int) -> None:
    """Rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist
    if rank == 1:
        raise ZeroDivisionError('rank 1 fails')
    dist.barrier()


def tree(root, cut: str = '') -> dict:
    """Every file under root: its bytes, by relative path, with ``cut``
    taken out wherever it occurs."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes().replace(cut.encode(), b'')
            for p in sorted(root.rglob('*')) if p.is_file()}
