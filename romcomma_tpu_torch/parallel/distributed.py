"""Dense single-output GP of the large-N variant route: on one device, or
over the ranks of a torch.distributed mesh.

Counterpart of ``romcomma_tpu/parallel/distributed.py``. ``DistributedGP``
takes one of two routes.

One device (a device, or a mesh of one rank, with no ``engine``): on one
card with native float64 and 80 GB, romcomma_tpu's single-device results
come from cuSOLVER and cuBLAS directly:

  - ``lml``: ``models.gp.ExactLML``, the exact log marginal likelihood with
    the analytic backward of romcomma_tpu's custom VJP, which the small
    route's ``gp.lml_single`` evaluates too. Its gram goes through
    ``ops.gram.rbf_gram``, so a float32 gram on a CUDA device is one launch
    of the hand-written unit-gram kernel, and the backward forms K^-1 once
    (``cholesky_inverse``) instead of differentiating through the Cholesky.
  - ``posterior_alpha``, ``predict``, ``make_psi_solver``: one float64
    Cholesky of the noisy gram, in the original row order. romcomma_tpu's
    factor ladder and iterative refinement repair a float32 factor; a
    float64 factor has nothing left to repair.
  - ``sobol_indices``: per output, one ``ClosedSobol`` (or
    ``ClosedSobolWithError``) calibrator from the float64 posterior, with
    every slice of every kind in one factorized interval pass.
  - ``calibrate``, ``calibrate_multi``: scipy L-BFGS-B over the eager
    value and gradient, in the working dtype.

A mesh (the ('n',) ``DeviceMesh`` that ``make_n_mesh()`` returns under a
process group; S ranks, one device each): romcomma_tpu's single-controller
``shard_map`` programs run SPMD, one rank per device, each rank holding the
(c B, Npad) row slab of every (Npad, Npad) object. Its ``ppermute`` ring
becomes ``batch_isend_irecv`` to the ranks on either side, ``psum``
``all_reduce`` and ``all_gather`` ``all_gather``; NCCL on cards, gloo on the
CPU. Two engines, as in romcomma_tpu:

  - 'cyclic' (``dense_kernels=False``): ``ring_gram``, the right-looking
    block-cyclic ``cholesky`` (the panel all-gathered, the trailing update
    local), ``solve_forward``, ``solve_backward``, ``log_diag_sum``; the
    backward builds K^-1 slab by slab from substitution sweeps and reduces
    the gradient from the slabs (``grads_stored``).
  - 'cyclic2' (``dense_kernels=True``): ``parallel.cyclic_deferred``, the
    left-looking super-panel factorization in global column order, its
    in-place triangular inverse and the half-ring pair-tile gradient.

Every tile of a ring gram goes through ``ops.gram.rbf_gram``, so a float32
tile on a card is one launch of the unit-gram kernel with two operands.
romcomma_tpu's precision tiers (HIGH, bf16_3x) are not carried: float32
products stay true float32. Every public method takes the same host inputs
on every rank and returns the same values there: the LML, its gradient,
posterior, predictions and indices are broadcast from rank 0 at the
boundary, so the ranks' scipy descents see the same bits and take every
branch together. The posterior is float64 over the same mesh, without the
refinement ladder. The GSA sweeps spread their chunks over the ranks
(``gsa.mesh``).

Storage layout (mesh route), romcomma_tpu's element for element: the N
axis is padded to NB B rows and block-permuted owner-major, stored block
t = d c + ci on rank d being global elimination block g = ci S + d. Rows and
columns of K are permuted alike; padding rows are unit-diagonal identity
rows with zero right-hand sides.

Hyperparameters enter constrained, as in romcomma_tpu: ls (M,), or (L, M)
for several outputs; s2 and noise scalars, or (L,).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from romcomma_tpu_torch.base.definitions import (FLOAT, device as compute_device,
                                                 in_process_group, pinned_device)
from romcomma_tpu_torch.models.gp import ExactLML
from romcomma_tpu_torch.models.params import NOISE_LOWER_BOUND
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.ops.gram import rbf_gram
from romcomma_tpu_torch.ops.linalg import cho_solve, cholesky as dense_cholesky, tri_solve
from romcomma_tpu_torch.ops.transforms import positive, positive_inverse

#: What a plain sequence of several devices is told: the engines span ranks.
MULTI_DEVICE_MESH = ('the multi-device engines run SPMD, one torch.distributed rank per device: '
                     'initialize a process group (parallel.multihost.init, under torchrun) and '
                     'pass make_n_mesh(), its (\'n\',) DeviceMesh')
TPU_TIERS = ('select reduced-precision or host-routed tiers of romcomma_tpu on the TPU; '
             'romcomma_tpu_torch computes the GSA in float64 on its device and has none')

#: Every slice of each GSA kind, for M input dims (romcomma_tpu's families).
FAMILIES: Dict[str, Callable[[int], list]] = {
    'first_order': lambda M: [(m, m + 1) for m in range(M)],
    'closed': lambda M: [(0, m + 1) for m in range(M)],
    'total': lambda M: [(m + 1, M) for m in range(M)]}


# --------------------------------------------------------------------------- #
# The mesh and the storage layout
# --------------------------------------------------------------------------- #

_MESHES: Dict[tuple, object] = {}


def make_n_mesh(n_devices: Optional[int] = None):
    """romcomma_tpu's ('n',) mesh. Without a process group (or inside
    ``base.definitions.solo()``), the compute device. Under one, an ('n',)
    ``DeviceMesh`` over all its ranks, each on its own device: the CUDA
    device torch has current (``multihost.init`` sets cuda:LOCAL_RANK), or
    the CPU where that was pinned. ``n_devices`` may be None, the group's
    size, or 1 (in a larger group: this rank's own device)."""
    if not in_process_group():
        if n_devices not in (None, 1):
            raise ValueError(f'make_n_mesh({n_devices}) without a process group: '
                             f'{MULTI_DEVICE_MESH}.')
        return compute_device()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    S = dist.get_world_size()
    if n_devices not in (None, S):
        if n_devices == 1:
            return compute_device()
        raise ValueError(f'make_n_mesh({n_devices}) in a process group of {S} ranks: the mesh '
                         f'spans every rank.')
    kind = compute_device().type
    key = (S, kind, id(dist.group.WORLD))
    if key not in _MESHES:
        _MESHES.clear()
        _MESHES[key] = init_device_mesh(kind, (S,), mesh_dim_names=('n',))
    return _MESHES[key]


def _is_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


class Plan(NamedTuple):
    """Static blocking plan for one (N, B, S) problem (romcomma_tpu's)."""
    N: int          # real rows
    B: int          # block size
    S: int          # ranks
    NB: int         # total blocks (padded)
    c: int          # blocks per rank
    Npad: int       # NB * B
    g_of_t: Tuple[int, ...]   # stored slot -> global elimination block
    perm: Tuple[int, ...]     # stored row  -> global row (< Npad)

    @property
    def dtype_rows_mask(self) -> np.ndarray:
        """(Npad,) bool: stored rows that are real data rows."""
        return np.asarray(self.perm) < self.N


def plan(N: int, S: int, B: int = 256) -> Plan:
    """Blocking plan: NB is the smallest multiple of S with NB*B >= N."""
    NB = max(1, math.ceil(N / (B * S))) * S
    c = NB // S
    Npad = NB * B
    g_of_t = tuple((t % c) * S + t // c for t in range(NB))
    perm = tuple(g_of_t[r // B] * B + r % B for r in range(Npad))
    return Plan(N=N, B=B, S=S, NB=NB, c=c, Npad=Npad, g_of_t=g_of_t, perm=perm)


def to_stored(pl_: Plan, a: np.ndarray, fill: float = 0.0) -> np.ndarray:
    """Host-side: global (N, ...) -> stored-order padded (Npad, ...)."""
    out = np.full((pl_.Npad,) + tuple(a.shape[1:]), fill, dtype=a.dtype)
    perm = np.asarray(pl_.perm)
    real = perm < pl_.N
    out[real] = np.asarray(a)[perm[real]]
    return out


def from_stored(pl_: Plan, a: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`to_stored` (drops padding)."""
    perm = np.asarray(pl_.perm)
    real = perm < pl_.N
    out = np.empty((pl_.N,) + tuple(a.shape[1:]), dtype=np.asarray(a).dtype)
    out[perm[real]] = np.asarray(a)[real]
    return out


def _stored_rows(pl_: Plan, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stored rows that are real, the global rows they hold), as index
    tensors: the on-device form of to_stored and from_stored."""
    perm = np.asarray(pl_.perm)
    real = np.flatnonzero(perm < pl_.N)
    return (torch.as_tensor(real, device=device), torch.as_tensor(perm[real], device=device))


def _to_stored_t(pl_: Plan, a: torch.Tensor) -> torch.Tensor:
    rows, held = _stored_rows(pl_, a.device)
    out = torch.zeros((pl_.Npad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    out[rows] = a[held]
    return out


def _from_stored_t(pl_: Plan, a: torch.Tensor) -> torch.Tensor:
    rows, held = _stored_rows(pl_, a.device)
    out = torch.empty((pl_.N,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    out[held] = a[rows]
    return out


class Ring:
    """This rank's place in an ('n',) mesh and the engines' collectives:
    romcomma_tpu's ppermute ring, psum and all_gather."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.mesh = mesh
        self.group = mesh.get_group()
        self.S = mesh.size()
        self.me = mesh.get_local_rank()
        self.ranks = [dist.get_global_rank(self.group, i) for i in range(self.S)]
        self.device = compute_device()

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (in place where t is contiguous)."""
        import torch.distributed as dist
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t, stacked on a leading rank axis."""
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.S)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)

    def from_rank(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s t on every rank (in place where t is contiguous)."""
        import torch.distributed as dist
        t = t.contiguous()
        dist.broadcast(t, src=self.ranks[rank], group=self.group)
        return t

    def agree(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's t on every rank: what a public method returns, so every
        rank sees the same bits."""
        return self.from_rank(t, 0)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """One step of the ring: t goes to the next rank, and the previous
        rank's comes back."""
        import torch.distributed as dist
        if self.S == 1:
            return t
        t, out = t.contiguous(), torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, self.ranks[(self.me + 1) % self.S], self.group),
               dist.P2POp(dist.irecv, out, self.ranks[(self.me - 1) % self.S], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


def _real_mask(pl_: Plan, dtype, device) -> torch.Tensor:
    """(Npad,) 1 at stored rows that are real data rows, else 0."""
    return torch.as_tensor(pl_.dtype_rows_mask, dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# The 'cyclic' engine: ring gram, block-cyclic Cholesky, solves
# --------------------------------------------------------------------------- #

def ring_gram(pl_: Plan, mesh):
    """The noisy stored-order gram, rows on their ranks.

    Returns fn(x_stored (Npad, M), the same on every rank, ls (M,), s2,
    noise) -> this rank's K rows (c B, Npad). X row blocks rotate around the
    ring; each tile is one ``rbf_gram`` of the rank's rows against the
    rotating block. Padding rows get a unit diagonal and zero off it."""
    ring = Ring(mesh)
    S, cB, Npad = pl_.S, pl_.c * pl_.B, pl_.Npad

    def build(x_stored, ls, s2, noise):
        me = ring.me
        x_local = x_stored[me * cB:(me + 1) * cB].contiguous()
        out = torch.empty((cB, Npad), dtype=x_stored.dtype, device=x_stored.device)
        buf = x_local
        for s in range(S):
            src = (me - s) % S                          # owner of buf's rows
            out[:, src * cB:(src + 1) * cB] = rbf_gram(x_local, buf, ls, s2)
            if s + 1 < S:
                buf = ring.shift(buf)
        real = _real_mask(pl_, out.dtype, out.device)
        row_real = real[me * cB:(me + 1) * cB]
        out.mul_(row_real[:, None]).mul_(real[None, :])
        rows = torch.arange(cB, device=out.device)
        out[rows, me * cB + rows] += torch.where(row_real > 0, noise, 1.0)
        return out

    return build


def _suffix(k: int, d: int, S: int) -> int:
    """The first local block ci of rank d whose global block ci S + d is > k."""
    return max(0, (k - d) // S + 1)


def _prefix(k: int, d: int, S: int) -> int:
    """How many local blocks of rank d have a global block < k."""
    return max(0, (k - d + S - 1) // S)


def cholesky(pl_: Plan, mesh):
    """The right-looking block-cyclic Cholesky of a stored-order
    SPD matrix: fn(K rows (c B, Npad)) -> L rows, block-lower, in place.

    Per global block k: the owner's panel column is all-gathered, every rank
    factors the diagonal block and solves the panel redundantly, keeps its
    rows, and updates its trailing rows (global block > k) against the
    panel's columns (global block > k) locally. A block that breaks down
    gives NaN, as ops.linalg.cholesky does."""
    ring = Ring(mesh)
    S, B, c, NB = pl_.S, pl_.B, pl_.c, pl_.NB
    g_of_t = pl_.g_of_t

    def factor(K_local):
        me = ring.me
        A = K_local.view(c, B, -1)
        for k in range(NB):
            t_k = (k % S) * c + k // S                  # stored slot of block k
            col = t_k * B
            panel = ring.gather(A[:, :, col:col + B]).reshape(NB, B, B)
            L_kk = dense_cholesky(panel[t_k])
            later = [t for t in range(NB) if g_of_t[t] > k]
            P_L = torch.zeros_like(panel)
            P_L[t_k] = L_kk
            if later:
                P_L[later] = torch.linalg.solve_triangular(
                    L_kk.mT, panel[later].reshape(-1, B), upper=True, left=False
                ).reshape(len(later), B, B)
            mine = P_L[me * c:(me + 1) * c]
            A[:, :, col:col + B] = mine
            r0 = _suffix(k, me, S)
            if r0 == c:
                continue
            rows = mine[r0:].reshape(-1, B)
            for d in range(S):
                c0 = _suffix(k, d, S)
                if c0 < c:
                    cols = P_L[d * c + c0:(d + 1) * c].reshape(-1, B)
                    A[r0:, :, (d * c + c0) * B:(d + 1) * c * B] -= (rows @ cols.mT).view(
                        c - r0, B, -1)
        for ci in range(c):                              # zero the stale upper part
            g = ci * S + me
            for d in range(S):
                c0 = _suffix(g, d, S)
                if c0 < c:
                    A[ci, :, (d * c + c0) * B:(d + 1) * c * B] = 0.0
            diagonal = A[ci, :, (me * c + ci) * B:(me * c + ci + 1) * B]
            diagonal.copy_(torch.tril(diagonal))
        return K_local

    return factor


def solve_forward(pl_: Plan, mesh):
    """fn(L rows, Y (Npad, R) the same on every rank) -> Z with L Z = Y, the
    same on every rank: per block, its owner solves and broadcasts."""
    ring = Ring(mesh)
    S, B, c, NB = pl_.S, pl_.B, pl_.c, pl_.NB

    def solve(L_local, Y):
        A = L_local.view(c, B, -1)
        Z = torch.zeros_like(Y)
        for k in range(NB):
            d_k, c_k = k % S, k // S
            col = (d_k * c + c_k) * B
            z_k = torch.empty((B, Y.shape[1]), dtype=Y.dtype, device=Y.device)
            if ring.me == d_k:
                slab = A[c_k]
                rhs = Y[col:col + B].clone()
                for d in range(S):                       # the solved blocks only
                    n_d = _prefix(k, d, S)
                    if n_d:
                        rhs -= slab[:, d * c * B:(d * c + n_d) * B] @ Z[d * c * B:(d * c + n_d) * B]
                z_k = torch.linalg.solve_triangular(slab[:, col:col + B], rhs, upper=False)
            Z[col:col + B] = ring.from_rank(z_k, d_k)
        return Z

    return solve


def solve_backward(pl_: Plan, mesh):
    """fn(L rows, Z (Npad, R) the same on every rank) -> W with L^T W = Z,
    the same on every rank: per block, one all_reduce of the ranks' partial
    products and the owner's diagonal block."""
    ring = Ring(mesh)
    S, B, c, NB = pl_.S, pl_.B, pl_.c, pl_.NB
    cB = c * B

    def solve(L_local, Z):
        me, R = ring.me, Z.shape[1]
        A = L_local.view(c, B, -1)
        W = torch.zeros_like(Z)
        for i in range(NB):
            k = NB - 1 - i
            d_k, c_k = k % S, k // S
            col = (d_k * c + c_k) * B
            pack = torch.zeros((B, R + B), dtype=Z.dtype, device=Z.device)
            r0 = _suffix(k, me, S)
            if r0 < c:
                pack[:, :R] = (A[r0:, :, col:col + B].reshape(-1, B).mT
                               @ W[me * cB + r0 * B:(me + 1) * cB])
            if me == d_k:
                pack[:, R:] = A[c_k, :, col:col + B]
            pack = ring.psum(pack)
            W[col:col + B] = torch.linalg.solve_triangular(
                pack[:, R:].mT, Z[col:col + B] - pack[:, :R], upper=True)
        return W

    return solve


def log_diag_sum(pl_: Plan, mesh):
    """fn(L rows) -> sum(log diag(L)) (padding contributes log 1 = 0)."""
    ring = Ring(mesh)
    B, c = pl_.B, pl_.c

    def logdiag(L_local):
        A = L_local.view(c, B, -1)
        acc = torch.zeros((), dtype=L_local.dtype, device=L_local.device)
        for ci in range(c):
            col = (ring.me * c + ci) * B
            acc = acc + torch.sum(torch.log(torch.diagonal(A[ci, :, col:col + B])))
        return ring.psum(acc)

    return logdiag


def grads_stored(pl_: Plan, mesh):
    """romcomma_tpu's ``_grads_fn``: fn(K rows, K^-1 rows, alpha
    (Npad, 1), x_stored (Npad, M), ls, s2, noise) -> (dls, ds2, dnoise) of
    the LML, from Bbar = dLML/dK = (alpha alpha^T - K^-1) / 2 through
    dK/ds2 = (K - noise I) / s2, dK/dnoise = I and dK/dls_m =
    (K - noise I) o D_m / ls_m^3: row and column sums of the rank's slab of
    W = Bbar o Knn and one (c B, Npad) @ (Npad, M) product, reduced over the
    ranks in one all_reduce. Consumes both slabs."""
    ring = Ring(mesh)
    cB, Npad = pl_.c * pl_.B, pl_.Npad

    def grads(K_local, Kinv_local, alpha, x, ls, s2, noise):
        rows0 = ring.me * cB
        real = _real_mask(pl_, K_local.dtype, K_local.device)
        row_real = real[rows0:rows0 + cB]
        rows = torch.arange(cB, device=K_local.device)
        W = Kinv_local.neg_().addr_(alpha[rows0:rows0 + cB, 0], alpha[:, 0]).mul_(0.5)
        W.mul_(row_real[:, None]).mul_(real[None, :])               # Bbar
        dnoise = torch.sum(W[rows, rows0 + rows])
        K_local[rows, rows0 + rows] -= noise
        W.mul_(K_local).mul_(row_real[:, None]).mul_(real[None, :])  # Bbar o Knn
        del K_local
        x_local = x[rows0:rows0 + cB]
        M = x.shape[1]
        pack = torch.cat([torch.sum(W)[None], dnoise[None],
                          (x_local * x_local).T @ torch.sum(W, dim=1)
                          - 2.0 * torch.sum(x_local * (W @ x), dim=0),
                          torch.sum(W, dim=0)])
        pack = ring.psum(pack)
        dls = (pack[2:2 + M] + (x * x).T @ pack[2 + M:]) / ls ** 3
        return dls, pack[0] / s2, pack[1]

    return grads


class CyclicEngine:
    """The 'cyclic' engine's bundle, with the interface of
    ``cyclic_deferred.DeferredEngine``: stored order at every boundary."""

    #: Bytes of an (Npad, Npad) L^-1 up to which one rank forms K^-1 as
    #: L^-T L^-1 (one substitution sweep and one product); beyond it, or on
    #: several ranks, K^-1 is built slab by slab from two sweeps per chunk
    #: of identity columns (romcomma_tpu's KINV_LINV_BUDGET_BYTES).
    KINV_LINV_BUDGET_BYTES: int = 5 * 2 ** 30
    #: Identity columns per chunk of the slab-by-slab K^-1 build.
    KINV_COLS: int = 2048

    def __init__(self, pl_: Plan, mesh):
        self.plan, self.ring = pl_, Ring(mesh)
        self.gram = ring_gram(pl_, mesh)
        self.chol = cholesky(pl_, mesh)
        self.fwd = solve_forward(pl_, mesh)
        self.bwd = solve_backward(pl_, mesh)
        self.logdiag = log_diag_sum(pl_, mesh)
        self._grads = grads_stored(pl_, mesh)

    def kinv(self, L_local: torch.Tensor) -> torch.Tensor:
        """This rank's rows of K^-1 (c B, Npad), from the factor."""
        pl_, ring = self.plan, self.ring
        Npad, cB = pl_.Npad, pl_.c * pl_.B
        eye = lambda cols: torch.eye(Npad, dtype=L_local.dtype, device=L_local.device)[:, cols]
        if pl_.S == 1 and Npad * Npad * L_local.element_size() <= self.KINV_LINV_BUDGET_BYTES:
            Linv = self.fwd(L_local, eye(slice(None)))
            return Linv.T @ Linv
        width = min(Npad, max(pl_.B, self.KINV_COLS))
        Kinv = torch.empty((cB, Npad), dtype=L_local.dtype, device=L_local.device)
        for start in range(0, Npad, width):
            col0 = min(start, Npad - width)
            chunk = self.bwd(L_local, self.fwd(L_local, eye(slice(col0, col0 + width))))
            Kinv[:, col0:col0 + width] = chunk[ring.me * cB:(ring.me + 1) * cB]
        return Kinv

    def residual(self, L_local: torch.Tensor) -> torch.Tensor:
        """What the backward keeps of the forward: the factor."""
        return L_local

    def grads(self, L_local, alpha, x_stored, ls, s2, noise):
        """(dls, ds2, dnoise): the gram rebuilt, K^-1 slab by slab."""
        K = self.gram(x_stored, ls, s2, noise)
        return self._grads(K, self.kinv(L_local), alpha, x_stored, ls, s2, noise)


class MeshLML(torch.autograd.Function):
    """lml(ls, s2, noise) of one output over a mesh engine, with the analytic
    backward of romcomma_tpu's ``_build_lml`` custom VJP. The value and the
    gradient are rank 0's on every rank. Forward inputs: ls (M,), s2 and
    noise scalars, x_stored (Npad, M) and y (Npad, 1) in stored order, the
    same on every rank, and the engine."""

    @staticmethod
    def forward(ctx, ls, s2, noise, x, y, engine):
        N = engine.plan.N
        K = engine.gram(x, ls, s2, noise)
        F = engine.chol(K)
        z = engine.fwd(F, y)
        alpha = engine.bwd(F, z)
        value = (-0.5 * torch.sum(z * z) - engine.logdiag(F)
                 - 0.5 * N * math.log(2.0 * math.pi))
        value = engine.ring.agree(torch.where(torch.isfinite(value), value, -torch.inf))
        ctx.engine = engine
        ctx.save_for_backward(ls, s2, noise, x, engine.residual(F), alpha)
        return value

    @staticmethod
    def backward(ctx, gbar):
        ls, s2, noise, x, R, alpha = ctx.saved_tensors
        dls, ds2, dnoise = ctx.engine.grads(R, alpha, x, ls, s2, noise)
        packed = ctx.engine.ring.agree(torch.cat([dls.reshape(-1), ds2.reshape(1),
                                                  dnoise.reshape(1)]))
        M = dls.numel()
        return (gbar * packed[:M].reshape(ls.shape), gbar * packed[M].reshape(s2.shape),
                gbar * packed[M + 1].reshape(noise.shape), None, None, None)


def _one_device(mesh) -> torch.device:
    """The device of a one-device ``mesh``: a device, or a sequence holding
    one device."""
    if isinstance(mesh, (torch.device, str)):
        return torch.device(mesh)
    devices = list(mesh)
    if len(devices) != 1:
        raise ValueError(f'DistributedGP got a plain sequence of {len(devices)} devices: '
                         f'{MULTI_DEVICE_MESH}.')
    return torch.device(devices[0])


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


class DistributedGP:
    """Exact single-output ARD-RBF GP on one device or over a mesh: LML
    (analytic backward), calibration, posterior solves and Sobol' indices,
    with romcomma_tpu's ``DistributedGP`` interface."""

    #: Bytes of the joint descent's gradient working set, 3 L (Npad, Npad)
    #: buffers, up to which calibrate_multi batches all outputs; romcomma_tpu's
    #: budget, so both packages take the joint descent at the same N.
    MULTI_MEMORY_BUDGET_BYTES: int = 12 * 2 ** 30
    #: Super-panel rows of the 'cyclic2' engine (romcomma_tpu's DENSE_SUPER_BLOCK).
    DENSE_SUPER_BLOCK: int = 3584

    def __init__(self, N: int, mesh=None, block: int = 256, dtype=None,
                 dense_kernels: bool = False, engine: Optional[str] = None):
        """``dtype``: the working dtype of staged arrays and so of the whole
        engine; None takes FLOAT(). np.float64 forces a float64 engine (the
        large route's rescue relies on it). ``mesh``: None (``make_n_mesh()``),
        a device, a sequence of one device, or an ('n',) ``DeviceMesh``.

        The engine, as romcomma_tpu selects it: on a mesh of S > 1 ranks
        'cyclic2' where ``dense_kernels``, else 'cyclic'; on one device, the
        one-device route. ``engine`` overrides it: 'cyclic' or 'cyclic2' on a
        mesh of any size, 'upper' (romcomma_tpu's single-device engine, here
        the one-device route) on one device only. ``block`` is the mesh's
        block size B; on one device it only sets ``fits_multi``'s padding."""
        if mesh is None:
            mesh = make_n_mesh()
        S = mesh.size() if _is_mesh(mesh) else 1
        if engine not in (None, 'upper', 'cyclic', 'cyclic2'):
            raise ValueError(f"DistributedGP engine={engine!r}: one of 'upper', 'cyclic', "
                             f"'cyclic2'.")
        if engine == 'upper' and S > 1:
            raise ValueError(f"engine='upper' is single-device only; this mesh has {S} devices "
                             f"- use engine='cyclic2'.")
        self.engine = (engine if engine in ('cyclic', 'cyclic2') else
                       None if S == 1 else 'cyclic2' if dense_kernels else 'cyclic')
        self.N, self.block = int(N), int(block)
        self.dtype = _torch_dtype(FLOAT() if dtype is None else dtype)
        self.mesh = self.plan = self._ops = None
        if self.engine is None:
            self.device = compute_device() if _is_mesh(mesh) else _one_device(mesh)
        elif not _is_mesh(mesh):
            raise ValueError(f'DistributedGP engine={self.engine!r} runs over a mesh: '
                             f'{MULTI_DEVICE_MESH}.')
        else:
            from romcomma_tpu_torch.parallel.cyclic_deferred import DeferredEngine
            self.mesh, self.plan = mesh, plan(self.N, S, self.block)
            self._ops = (CyclicEngine(self.plan, mesh) if self.engine == 'cyclic' else
                         DeferredEngine(self.plan, mesh, self.DENSE_SUPER_BLOCK))
            self.device = self._ops.ring.device
        self._stage_token = 0
        self._staged = None
        self._alpha_cache = None
        self.last_gsa_timings: Dict[str, float] = {}

    # -- staging ------------------------------------------------------------ #

    def _as_working(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.detach().to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    def _device_arrays(self, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
        x_dev = self._as_working(X)
        if x_dev.shape[0] != self.N:
            raise ValueError(f'DistributedGP of N={self.N} rows got X of shape '
                             f'{tuple(x_dev.shape)}.')
        y_dev = self._as_working(Y).reshape(self.N, -1)
        if self.plan is None:
            return x_dev, y_dev
        return _to_stored_t(self.plan, x_dev), _to_stored_t(self.plan, y_dev)

    def stage(self, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host X (N, M) and Y (N,) | (N, L) as tensors on the device, in the
        working dtype: in the original row order on one device, in stored
        order (Npad rows, the same on every rank) on a mesh. Each call takes
        a new stage token, which keys the posterior cache of
        ``sobol_indices``: a staged pair is recognised by identity while this
        engine holds it."""
        x_dev, y_dev = self._device_arrays(X, Y)
        self._stage_token += 1
        self._staged = (self._stage_token, x_dev, y_dev)
        return x_dev, y_dev

    def _stage_token_of(self, x_dev, y_dev) -> Optional[int]:
        if self._staged is not None and x_dev is self._staged[1] and y_dev is self._staged[2]:
            return self._staged[0]
        return None

    @staticmethod
    def _cast(x_dev: torch.Tensor, *values) -> Tuple[torch.Tensor, ...]:
        """Hyperparameters as tensors of x_dev's dtype on its device; a tensor
        keeps its autograd graph."""
        return tuple(v.to(device=x_dev.device, dtype=x_dev.dtype) if torch.is_tensor(v) else
                     torch.as_tensor(np.array(v, dtype=np.float64), dtype=x_dev.dtype,
                                     device=x_dev.device) for v in values)

    # -- LML ------------------------------------------------------------------ #

    def lml(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor) -> torch.Tensor:
        """The exact LML of one output (scalar), differentiable in ls, s2 and
        noise, in x_dev's dtype; -inf where the factorization breaks down. On
        a mesh, y_dev is one staged column (Npad, 1), and the value and its
        gradient are rank 0's on every rank."""
        ls, s2, noise = self._cast(x_dev, ls, s2, noise)
        if self.plan is None:
            return ExactLML.apply(ls, s2, noise, x_dev, y_dev)
        y = y_dev.reshape(self.plan.Npad, -1)
        if y.shape[1] != 1:
            raise ValueError(f'DistributedGP.lml takes one output; y_dev has {y.shape[1]}.')
        return MeshLML.apply(ls, s2, noise, x_dev, y, self._ops)

    def _column(self, y_dev: torch.Tensor, l: int) -> torch.Tensor:
        """Output l of staged Y, as lml takes it."""
        return y_dev[:, l] if self.plan is None else y_dev[:, l:l + 1]

    # -- posterior ------------------------------------------------------------ #

    def _factor64(self, ls, s2, noise, x_dev: torch.Tensor) -> torch.Tensor:
        """The float64 Cholesky factor of the noisy gram at x_dev's rows."""
        x64 = x_dev.to(torch.float64)
        ls, s2, noise = self._cast(x64, ls, s2, noise)
        K = rbf_gram(x64, x64, ls.detach(), s2.detach())
        K.diagonal().add_(noise.detach())
        return dense_cholesky(K)

    def _mesh_factor64(self, ls, s2, noise, x_dev: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the float64 factor of the noisy gram, from the
        mesh engine run on float64 inputs."""
        x64 = x_dev.to(torch.float64)
        ls, s2, noise = (v.detach() for v in self._cast(x64, ls, s2, noise))
        return self._ops.chol(self._ops.gram(x64, ls, s2, noise))

    def posterior_alpha(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha = K^-1 y, its float64 Cholesky factor), float64. On one
        device alpha is (N, R) for y_dev (N,) | (N, R), and the factor (N, N),
        both in the original row order. On a mesh, as romcomma_tpu: alpha
        (Npad, R) in stored order, the same on every rank, and this rank's
        rows of the factor. romcomma_tpu's ``refine`` rounds repair a float32
        or bf16x3 factor against float64 residuals; a float64 factor leaves
        nothing to refine, so there is no such argument."""
        with torch.no_grad():
            if self.plan is None:
                chol = self._factor64(ls, s2, noise, x_dev)
                return cho_solve(chol, y_dev.reshape(self.N, -1).to(torch.float64)), chol
            F = self._mesh_factor64(ls, s2, noise, x_dev)
            y = y_dev.reshape(self.plan.Npad, -1).to(torch.float64)
            return self._ops.ring.agree(self._ops.bwd(F, self._ops.fwd(F, y))), F

    def predict(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor, Xs
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean (o,) and variance max(s2 - |L^-1 Ks|^2, 0) + noise
        (o,) at test points Xs (o, M), float64. Ks is built in the working
        dtype (through the unit-gram kernel for a float32 CUDA engine), the
        rest from the float64 posterior."""
        with torch.no_grad():
            alpha, chol = self.posterior_alpha(ls, s2, noise, x_dev, y_dev)
            ls_w, s2_w = self._cast(x_dev, ls, s2)
            Ks = rbf_gram(x_dev, self._cast(x_dev, Xs)[0], ls_w, s2_w).to(torch.float64)
            s2_64, noise_64 = self._cast(alpha, s2, noise)
            if self.plan is not None:                # stored order, padding rows 0
                Ks *= _real_mask(self.plan, Ks.dtype, Ks.device)[:, None]
            A = tri_solve(chol, Ks) if self.plan is None else self._ops.fwd(chol, Ks)
            out = torch.stack([(Ks.T @ alpha)[:, 0],
                               torch.clamp(s2_64 - torch.sum(A * A, dim=0), min=0.0) + noise_64])
            if self.plan is not None:
                out = self._ops.ring.agree(out)
            return out[0], out[1]

    def make_psi_solver(self, ls, s2, noise, x_dev: torch.Tensor,
                        factor: Optional[torch.Tensor] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
        """A function applying K^-1 along the last axis of a float64
        (..., N) array (numpy or tensor) in the original row order, returning
        a float64 tensor on this engine's device. It reuses ``factor``, the
        float64 factor of this gram (posterior_alpha's second return), when
        one is given."""
        with torch.no_grad():
            if factor is not None:
                chol = factor
            elif self.plan is None:
                chol = self._factor64(ls, s2, noise, x_dev)
            else:
                chol = self._mesh_factor64(ls, s2, noise, x_dev)

        def solver(f) -> torch.Tensor:
            f = torch.as_tensor(f, dtype=torch.float64).to(chol.device)
            with torch.no_grad():
                rhs = f.reshape(-1, self.N).T
                if self.plan is None:
                    return cho_solve(chol, rhs).T.reshape(f.shape)
                solved = self._ops.bwd(chol, self._ops.fwd(chol, _to_stored_t(self.plan, rhs)))
                return _from_stored_t(self.plan, solved).T.reshape(f.shape)

        return solver

    def _half_solver(self, factor: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
        """The mesh's half solve of the error GSA's psi factors (..., N): the
        stored-order forward solve against this rank's float64 factor rows,
        (..., Npad). Its quadforms over the last axis are the f1^T K^-1 f2 of
        a half solve against the factor in the original order."""
        def half(f: torch.Tensor) -> torch.Tensor:
            rhs = _to_stored_t(self.plan, f.reshape(-1, self.N).T)
            return self._ops.fwd(factor, rhs).T.reshape(f.shape[:-1] + (self.plan.Npad,))

        return half

    # -- Sobol' indices -------------------------------------------------------- #

    def sobol_indices(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor, X,
                      kind='first_order', n_chunk: Optional[int] = None, gsa_dtype=None,
                      error: bool = False, is_T_partial: bool = True,
                      intervals_mixed=None, error_solver: str = 'auto'):
        """Closed-form Sobol' indices of the trained GP (romcomma_tpu's
        ``sobol_indices``), in float64 on this engine's device.

        ``kind``: one of 'first_order', 'closed', 'total' -> {m: S_m}; or a
        tuple of kinds -> {kind: {m: S_m}}, every slice of every kind in one
        factorized pass. 'total' is 1 - S of the complement's slice. With
        ``error`` -> {'S': that structure, 'T': its standard errors, the same
        shape}; ``is_T_partial`` picks the reference's partial or total T.
        ``ls`` (L, M) with s2 and noise (L,) and y_dev (N, L) -> a list, one
        structure per output. ``X`` is the float64 input the calibrator sees
        (the host data). ``n_chunk`` sets the calibrator's chunk.

        romcomma_tpu's TPU tiers are refused: ``gsa_dtype`` other than None or
        float64, ``intervals_mixed`` other than None or False, and
        ``error_solver='device'`` (its float32 psi solver). ``error_solver``
        'auto' and 'host' both take the float64 factor, as romcomma_tpu's host
        route does. Sets ``last_gsa_timings`` (seconds) with romcomma_tpu's
        keys."""
        if gsa_dtype is not None and np.dtype(gsa_dtype) != np.float64:
            raise ValueError(f'sobol_indices gsa_dtype={np.dtype(gsa_dtype).name}: reduced GSA '
                             f'planes {TPU_TIERS}.')
        if intervals_mixed not in (None, False):
            raise ValueError(f'sobol_indices intervals_mixed={intervals_mixed!r}: the exp tiers '
                             f'{TPU_TIERS}.')
        if error_solver not in ('auto', 'host'):
            raise ValueError(f'sobol_indices error_solver={error_solver!r}: the device psi '
                             f'solver and its refinement {TPU_TIERS}.')
        t0 = time.perf_counter()
        ls_arr = ls.detach().cpu().numpy() if torch.is_tensor(ls) else np.asarray(ls)
        args_fetch = time.perf_counter() - t0
        options = dict(kind=kind, n_chunk=n_chunk, error=error, is_T_partial=is_T_partial)
        if ls_arr.ndim == 1:
            return self._sobol_indices_one(ls_arr, s2, noise, x_dev, y_dev, X,
                                           args_fetch=args_fetch, **options)
        outputs = ls_arr.shape[0]
        s2_arr, noise_arr = (np.reshape(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                                        outputs) for v in (s2, noise))
        results, timings = [], {}
        for l in range(outputs):
            results.append(self._sobol_indices_one(ls_arr[l], s2_arr[l], noise_arr[l], x_dev,
                                                   y_dev[:, l:l + 1], X, args_fetch=args_fetch,
                                                   **options))
            for key in ('posterior_s', 'intervals_s', 'k_cho_s', 'total_s'):
                timings[key] = timings.get(key, 0.0) + self.last_gsa_timings.get(key, 0.0)
        self.last_gsa_timings = ({k: timings[k] for k in ('posterior_s', 'intervals_s')}
                                 | {'args_fetch_s': args_fetch, 'outputs': outputs}
                                 | ({'k_cho_s': timings['k_cho_s'], 'total_s': timings['total_s']}
                                    if error else {}))
        return results

    def _sobol_indices_one(self, ls: np.ndarray, s2, noise, x_dev: torch.Tensor,
                           y_dev: torch.Tensor, X, kind, n_chunk, error: bool,
                           is_T_partial: bool, args_fetch: float):
        """One output's indices (see sobol_indices). Without ``error`` the
        posterior alpha is cached per stage token and hyperparameters, so
        repeated analytics of one trained model on one staged pair solve once.
        On a mesh the calibrator's sweeps spread their chunks over the ranks
        (its ``gsa_mesh``), the psi factors are half-solved against the mesh's
        float64 factor, and V and T are rank 0's."""
        t_start = time.perf_counter()
        from romcomma_tpu_torch.gsa.calibrators import (ClosedSobol, ClosedSobolWithError,
                                                        _synchronize)
        t_import = time.perf_counter() - t_start
        kinds = (kind,) if isinstance(kind, str) else tuple(kind)
        s2, noise = (float(v) for v in (s2, noise))
        t0 = time.perf_counter()
        token = self._stage_token_of(x_dev, y_dev)
        key = (ls.tobytes(), s2, noise, token)
        if not error and token is not None and self._alpha_cache is not None \
                and self._alpha_cache[0] == key:
            alpha = self._alpha_cache[1]
        else:
            alpha, chol = self.posterior_alpha(ls, s2, noise, x_dev, y_dev)
            if not error:
                del chol
                self._alpha_cache = (key, alpha) if token is not None else None
        _synchronize(alpha)
        t_posterior = time.perf_counter() - t0
        N, M = self.N, ls.shape[-1]
        meta = {} if n_chunk is None else {'n_chunk': n_chunk}
        t0 = time.perf_counter()
        K_cho = torch.zeros((1, 1, 1), dtype=torch.float64, device=self.device)
        if error:
            meta['is_T_partial'] = bool(is_T_partial)
            if self.plan is None:
                K_cho = chol[None]
            else:
                meta['psi_half_solver'] = self._half_solver(chol)
        if self.plan is not None:
            alpha = _from_stored_t(self.plan, alpha)
        t_kcho = time.perf_counter() - t0
        t0 = time.perf_counter()
        with pinned_device(self.device):
            cal = (ClosedSobolWithError if error else ClosedSobol).from_arrays(
                F=np.asarray([[s2]]), K_cho=K_cho, K_inv_Y=alpha.T.reshape(1, 1, N),
                Lambda=ls[None, :], X=X, is_F_diagonal=True, L=1, M=M, N=N, **meta)
            _synchronize(cal.V[0])
            t_setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            if self.mesh is not None:
                cal.gsa_mesh = self.mesh
            flat = [(0, M)] + [s for k in kinds for s in FAMILIES[k](M)]
            out = cal.marginalize_intervals(tuple(flat))
            if self.mesh is not None:
                out = {key: self._ops.ring.agree(value) for key, value in out.items()}
            V_all = out['V'][0, 0].cpu().numpy()
        t_intervals = time.perf_counter() - t0
        sweep = getattr(cal, 'last_interval_timings', None) or {
            f'v_{k}': v for k, v in cal.last_v_sweep_timings.items()}
        self.last_gsa_timings = {'posterior_s': t_posterior, 'setup_s': t_setup,
                                 'intervals_s': t_intervals, 'import_s': t_import,
                                 'args_fetch_s': args_fetch,
                                 'total_s': time.perf_counter() - t_start}
        self.last_gsa_timings.update({f'iv_{k}': v for k, v in sweep.items()})
        S_out = self._kinds_from_V(V_all, kinds, M, kind)
        if not error:
            return S_out
        self.last_gsa_timings['k_cho_s'] = t_kcho
        t0 = time.perf_counter()
        T_all = out['T'][0, 0][1:].cpu().numpy()
        self.last_gsa_timings['t_assembly_s'] = time.perf_counter() - t0
        T_by_kind = {k: {m: float(T_all[i * M + m]) for m in range(M)}
                     for i, k in enumerate(kinds)}
        return {'S': S_out, 'T': T_by_kind[kind] if isinstance(kind, str) else T_by_kind}

    @staticmethod
    def _kinds_from_V(V_col: np.ndarray, kinds: tuple, M: int, kind):
        """{kind: {m: S}} from one output's V column [V0, kinds[0] slices (M),
        kinds[1] slices (M), ...]; 'total' applies the reference's S_M minus
        S of the complement (romcomma_tpu's ``_kinds_from_V``)."""
        S_all = V_col[1:] / float(V_col[0])
        by_kind = {k: {m: (1.0 - float(v) if k == 'total' else float(v))
                       for m, v in enumerate(S_all[i * M:(i + 1) * M])}
                   for i, k in enumerate(kinds)}
        return by_kind[kind] if isinstance(kind, str) else by_kind

    # -- calibration ----------------------------------------------------------- #

    def _raw0(self, x_dev, ls0, s2_0, noise0, outputs: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
        """Raw (unconstrained) starting parameters in the working dtype; with
        ``outputs``, ls0 broadcast to (L, M) and s2_0, noise0 to (L,)."""
        ls0, s2_0, noise0 = self._cast(x_dev, ls0, s2_0, noise0)
        if outputs is not None:
            ls0 = torch.broadcast_to(ls0, (outputs, x_dev.shape[1]))
            s2_0, noise0 = s2_0.reshape(outputs), noise0.reshape(outputs)
        return {'ls': positive_inverse(ls0, 0.0), 's2': positive_inverse(s2_0, 0.0),
                'noise': positive_inverse(noise0, NOISE_LOWER_BOUND)}

    @staticmethod
    def _merge(raw0: Dict[str, torch.Tensor], mask: Sequence[float]):
        """The mask (ls, s2, noise) of 0/1 floats as romcomma_tpu merges it:
        frozen groups stay at raw0 through fv + m (rv - fv); all ones is the
        identity."""
        weights = dict(zip(('ls', 's2', 'noise'), (float(m) for m in mask)))
        if all(w == 1.0 for w in weights.values()):
            return lambda raw: raw
        return lambda raw: {name: raw0[name] + weights[name] * (raw[name] - raw0[name])
                            for name in raw}

    @staticmethod
    def _constrain(raw: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (positive(raw['ls'], 0.0), positive(raw['s2'], 0.0),
                positive(raw['noise'], NOISE_LOWER_BOUND))

    def calibrate(self, X, Y, ls0, s2_0, noise0, maxiter: int = 5000, gtol: float = 1e-16,
                  max_linesearch_steps: Optional[int] = None,
                  mask: tuple = (1.0, 1.0, 1.0)):
        """L-BFGS-B maximization of one output's LML (Y (N,) or (N, 1)): one
        scipy descent over the eager value and gradient, romcomma_tpu's
        single-device production branch. On a mesh every rank runs this
        descent in lockstep, on rank 0's LML and gradient, so every rank takes
        the same steps and returns the same bits. ``mask`` = (lengthscales, signal
        variance, noise) trainability as 0/1 floats. Returns ((ls, s2, noise),
        lml, iterations), lml being the optimizer's own final value (-inf
        where the factorization breaks down there)."""
        x_dev, y_dev = self._device_arrays(X, Y)
        raw0 = self._raw0(x_dev, ls0, s2_0, noise0)
        merge = self._merge(raw0, mask)

        def objective(raw):
            return -self.lml(*self._constrain(merge(raw)), x_dev, y_dev[:, :1])

        res = lbfgs.minimize(objective, raw0, maxiter=maxiter, gtol=gtol,
                             max_linesearch_steps=max_linesearch_steps)
        with torch.no_grad():
            return self._constrain(merge(res.params)), -res.value, res.iterations

    def fits_multi(self, L: int) -> bool:
        """Whether romcomma_tpu's joint L-output descent fits its memory rule,
        3 L Npad^2 itemsize <= MULTI_MEMORY_BUDGET_BYTES, Npad being N padded
        to a multiple of ``block`` as romcomma_tpu pads it."""
        padded = (-(-self.N // self.block) * self.block if self.plan is None else
                  self.plan.Npad)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 3 * L * padded ** 2 * itemsize <= self.MULTI_MEMORY_BUDGET_BYTES

    def calibrate_multi(self, X, Y, ls0, s2_0, noise0, maxiter: int = 5000,
                        gtol: float = 1e-16, max_linesearch_steps: Optional[int] = None,
                        mask: tuple = (1.0, 1.0, 1.0)):
        """One joint L-BFGS-B descent of L independent outputs sharing X: the
        objective is the sum of the per-output LMLs, evaluated one output
        after another. romcomma_tpu runs this descent with optax's L-BFGS; the
        port runs scipy's, as its small route does. ``ls0`` (L, M) or (M,),
        ``s2_0`` and ``noise0`` (L,), ``Y`` (N, L). Returns ((ls (L, M),
        s2 (L,), noise (L,)), lml (L,), iterations), the LMLs evaluated afresh
        at the optimum."""
        x_dev, y_dev = self._device_arrays(X, Y)
        outputs = y_dev.shape[1]
        raw0 = self._raw0(x_dev, ls0, s2_0, noise0, outputs)
        merge = self._merge(raw0, mask)

        def lmls(raw) -> torch.Tensor:
            ls, s2, noise = self._constrain(merge(raw))
            return torch.stack([self.lml(ls[l], s2[l], noise[l], x_dev, self._column(y_dev, l))
                                for l in range(outputs)])

        res = lbfgs.minimize(lambda raw: -torch.sum(lmls(raw)), raw0, maxiter=maxiter,
                             gtol=gtol, max_linesearch_steps=max_linesearch_steps)
        with torch.no_grad():
            return self._constrain(merge(res.params)), lmls(res.params), res.iterations
