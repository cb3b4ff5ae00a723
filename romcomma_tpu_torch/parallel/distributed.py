"""Dense single-output GP of the large-N variant route: on one device, or
over the ranks of a torch.distributed mesh.

Counterpart of ``romcomma_tpu/parallel/distributed.py``. ``DistributedGP``
runs one of romcomma_tpu's three engines, chosen as romcomma_tpu chooses
(``DistributedGP.__init__``): with ``dense_kernels`` (the large route's
production choice) 'cyclic2' on a mesh of several ranks and on one device
from N = ``CYCLIC2_SINGLE_CHIP_MIN_N``, 'upper' on one device below it;
without, 'cyclic'.

'upper' (one device): on one card with native float64 and 80 GB,
romcomma_tpu's single-device results come from cuSOLVER and cuBLAS directly:

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
  - ``sobol_indices``: one ``ClosedSobol`` (or ``ClosedSobolWithError``)
    calibrator per output from the float64 posterior, with every slice of
    every kind in one factorized interval pass, several outputs stacked in
    one pass.
  - ``calibrate``, ``calibrate_multi``: scipy L-BFGS-B over the eager
    value and gradient, in the working dtype.

'cyclic' and 'cyclic2' run over the ranks of an ('n',) ``DeviceMesh``
(``make_n_mesh()`` under a process group; S ranks, one device each), or on
one device with no process group, where S = 1 and every collective of
``Ring`` is the identity, as on romcomma_tpu's one-device mesh.
romcomma_tpu's single-controller ``shard_map`` programs run SPMD, one rank
per device, each rank holding the (c B, Npad) row slab of every (Npad,
Npad) object. Its ``ppermute`` ring becomes ``batch_isend_irecv`` to the
ranks on either side, ``psum`` ``all_reduce`` and ``all_gather``
``all_gather``; NCCL on cards, gloo on the CPU:

  - 'cyclic': ``ring_gram``, the right-looking block-cyclic ``cholesky``
    (the panel all-gathered, the trailing update local), ``solve_forward``,
    ``solve_backward``, ``log_diag_sum``; the backward builds K^-1 slab by
    slab from substitution sweeps and reduces the gradient from the slabs
    (``grads_stored``). On one device of at most ``DENSE_DIRECT_MAX_N`` rows
    it calibrates through ``ExactLML``, romcomma_tpu's dense direct descent.
  - 'cyclic2': ``parallel.cyclic_deferred``, the left-looking super-panel
    factorization in global column order, its in-place triangular inverse
    and the half-ring pair-tile gradient: one (Npad, Npad) buffer in the
    factor's dtype (float64 on one device, the bytes of two float32
    buffers; see ``MeshLML``), where 'upper' holds three float32 ones.

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
from romcomma_tpu_torch.ops.gram import _use_kernel, rbf_gram
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
    romcomma_tpu's ppermute ring, psum and all_gather. On one device (a
    device, no process group) S = 1, me = 0 and every collective is the
    identity, as romcomma_tpu's are on a one-device mesh; each returns what
    the one-rank group returns (a contiguous tensor, a fresh stack from
    ``gather``), so an engine on one device computes what it computes on a
    one-rank group, bit for bit."""

    def __init__(self, mesh):
        self.mesh = mesh
        if _is_mesh(mesh):
            import torch.distributed as dist
            self.group = mesh.get_group()
            self.S = mesh.size()
            self.me = mesh.get_local_rank()
            self.ranks = [dist.get_global_rank(self.group, i) for i in range(self.S)]
            self.device = compute_device()
        else:
            self.group, self.S, self.me, self.ranks = None, 1, 0, [0]
            self.device = _one_device(mesh)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (in place where t is contiguous)."""
        t = t.contiguous()
        if self.group is not None:
            import torch.distributed as dist
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t, stacked on a leading rank axis."""
        if self.group is None:
            return torch.stack([t])
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.S)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)

    def from_rank(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s t on every rank (in place where t is contiguous)."""
        t = t.contiguous()
        if self.group is not None:
            import torch.distributed as dist
            dist.broadcast(t, src=self.ranks[rank], group=self.group)
        return t

    def agree(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's t on every rank: what a public method returns, so every
        rank sees the same bits."""
        return self.from_rank(t, 0)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """One step of the ring: t goes to the next rank, and the previous
        rank's comes back."""
        if self.S == 1:
            return t
        import torch.distributed as dist
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

#: Rows of a ring tile built at once where it is not one launch: the plain
#: gram holds a few temporaries of its own size, which a whole (Npad, Npad)
#: float64 tile at N = 50000 (20 GB each) cannot afford, and a float32 tile
#: kept in float64 is launched strip by strip so that no whole float32 copy
#: lives beside it.
TILE_STRIP_ROWS = 4096


def ring_tile(u: torch.Tensor, v: torch.Tensor, ls, s2, dtype=None) -> torch.Tensor:
    """One tile of a ring gram, ``rbf_gram(u, v, ls, s2)``, in ``dtype``
    (u's by default): one launch of the unit-gram kernel where the inputs
    are float32 on a card and the tile stays float32 (one operand packed
    when u is v), else strips of TILE_STRIP_ROWS rows written into the tile,
    each one launch of the kernel (two operands) or the plain gram."""
    dtype = u.dtype if dtype is None else dtype
    if dtype == u.dtype and (_use_kernel(u, v, ls, s2) or u.shape[0] <= TILE_STRIP_ROWS):
        return rbf_gram(u, v, ls, s2)
    out = torch.empty((u.shape[0], v.shape[0]), dtype=dtype, device=u.device)
    for r0 in range(0, u.shape[0], TILE_STRIP_ROWS):
        out[r0:r0 + TILE_STRIP_ROWS] = rbf_gram(u[r0:r0 + TILE_STRIP_ROWS], v, ls, s2)
    return out


def ring_gram(pl_: Plan, mesh):
    """The noisy stored-order gram, rows on their ranks.

    Returns fn(x_stored (Npad, M), the same on every rank, ls (M,), s2,
    noise, dtype=None) -> this rank's K rows (c B, Npad) in ``dtype``
    (x_stored's by default; the tiles in x_stored's, the noise added in
    ``dtype``). X row blocks rotate around the ring; each tile is one
    ``rbf_gram`` of the rank's rows against the rotating block. On one rank
    the one tile is the whole gram (``ring_tile``, no copy). Padding rows
    get a unit diagonal and zero off it."""
    ring = Ring(mesh)
    S, cB, Npad = pl_.S, pl_.c * pl_.B, pl_.Npad

    def build(x_stored, ls, s2, noise, dtype=None):
        me = ring.me
        x_local = x_stored[me * cB:(me + 1) * cB].contiguous()
        if S == 1:
            out = ring_tile(x_local, x_local, ls, s2, dtype)
        else:
            out = torch.empty((cB, Npad), dtype=dtype or x_stored.dtype, device=x_stored.device)
            buf = x_local
            for s in range(S):
                src = (me - s) % S                      # owner of buf's rows
                out[:, src * cB:(src + 1) * cB] = ring_tile(x_local, buf, ls, s2)
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
        x = x.to(Kinv_local.dtype)                   # the reductions in K^-1's dtype
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
    same on every rank, and the engine.

    On one device or one rank (S = 1) the LML is computed in float64
    whatever the engine's dtype: a float32 engine's gram is built through
    the unit-gram kernel in float32 strips written into one float64
    (Npad, Npad) buffer (``ring_tile``), the noise added there, and the
    factor, solves, in-place inverse and reductions are float64; the value
    is returned in float64, the precision it is computed in, and the
    gradient in the engine's dtype. A float32 descent needs it: in float32
    the north star's descent on 'cyclic2' at N=20000 ends with S1 0.012 from
    the problem's (PERF.md), since a value rounded to float32 moves in steps
    of 0.002 at |LML| ~ 2e4, where scipy's relative-reduction rule (2.2e-9
    |f| = 4e-5) then ends a descent at the first step that rounds to no
    gain, and the float32 factor costs the gradient its digits. There
    dLML/ds2 comes from Euler's identity: K = s2 E + noise I is homogeneous
    of degree one in (s2, noise), so s2 dLML/ds2 + noise dLML/dnoise =
    (y^T K^-1 y - N) / 2, the value's own quadratic term.

    Over several ranks (S > 1) every step runs in the engine's dtype, as
    romcomma_tpu's engines do (float32 products true float32), dLML/ds2 the
    engine's reduction of sum(Bbar o Knn), and each rank holds its (c B,
    Npad) slab in that dtype."""

    @staticmethod
    def forward(ctx, ls, s2, noise, x, y, engine):
        N = engine.plan.N
        F = engine.chol(engine.gram(x, ls, s2, noise,
                                    torch.float64 if engine.plan.S == 1 else x.dtype))
        z = engine.fwd(F, y.to(F.dtype))
        alpha = engine.bwd(F, z)
        quad = torch.sum(z * z)
        value = -0.5 * quad - engine.logdiag(F) - 0.5 * N * math.log(2.0 * math.pi)
        value = engine.ring.agree(torch.where(torch.isfinite(value), value, -torch.inf))
        ctx.engine = engine
        ctx.save_for_backward(ls, s2, noise, x, engine.residual(F), alpha, quad)
        return value

    @staticmethod
    def backward(ctx, gbar):
        ls, s2, noise, x, R, alpha, quad = ctx.saved_tensors
        plan = ctx.engine.plan
        dls, ds2, dnoise = ctx.engine.grads(R, alpha, x, ls, s2, noise)
        if plan.S == 1:
            ds2 = (0.5 * (quad - plan.N) - noise * dnoise) / s2
        packed = gbar * ctx.engine.ring.agree(torch.cat([dls.reshape(-1), ds2.reshape(1),
                                                         dnoise.reshape(1)]))
        M = dls.numel()
        return (packed[:M].reshape(ls.shape).to(ls.dtype),
                packed[M].reshape(s2.shape).to(s2.dtype),
                packed[M + 1].reshape(noise.shape).to(noise.dtype), None, None, None)


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
    #: N from which ``dense_kernels`` takes 'cyclic2' on one device too
    #: (romcomma_tpu's, ``distributed.py:410``): one (Npad, Npad) buffer
    #: (float64 on one device) and the pair-tile gradient, where 'upper'
    #: holds three float32 ones.
    CYCLIC2_SINGLE_CHIP_MIN_N: int = 16384
    #: N up to which a one-device 'cyclic' engine calibrates through the dense
    #: exact LML, romcomma_tpu's dense direct descent (``distributed.py:366``).
    DENSE_DIRECT_MAX_N: int = 21000

    def __init__(self, N: int, mesh=None, block: int = 256, dtype=None,
                 dense_kernels: bool = False, engine: Optional[str] = None):
        """``dtype``: the working dtype of staged arrays and so of the whole
        engine; None takes FLOAT(). np.float64 forces a float64 engine (the
        large route's rescue relies on it). ``mesh``: None (``make_n_mesh()``),
        a device, a sequence of one device, or an ('n',) ``DeviceMesh``.

        The engine (``self.engine``), as romcomma_tpu selects it
        (``distributed.py:438-506``): with ``dense_kernels``, 'cyclic2' on a
        mesh of S > 1 ranks and on one device from N =
        CYCLIC2_SINGLE_CHIP_MIN_N, else 'upper'; without, 'cyclic'.
        ``engine`` overrides it: 'cyclic' or 'cyclic2' on a mesh of any size
        or on one device (their collectives then the identity), 'upper' on
        one device only. 'upper' is the port's one-device route (ExactLML and
        dense float64 posteriors, in the original row order); the other two
        hold every (Npad, Npad) object in stored order. ``block`` is the
        engines' block size B; for 'upper' it only sets ``fits_multi``'s
        padding."""
        if mesh is None:
            mesh = make_n_mesh()
        if not _is_mesh(mesh):
            mesh = _one_device(mesh)
        S = mesh.size() if _is_mesh(mesh) else 1
        if engine not in (None, 'upper', 'cyclic', 'cyclic2'):
            raise ValueError(f"DistributedGP engine={engine!r}: one of 'upper', 'cyclic', "
                             f"'cyclic2'.")
        if engine == 'upper' and S > 1:
            raise ValueError(f"engine='upper' is single-device only; this mesh has {S} devices "
                             f"- use engine='cyclic2'.")
        if engine is None:
            engine = ('cyclic' if not dense_kernels else
                      'cyclic2' if S > 1 or N >= self.CYCLIC2_SINGLE_CHIP_MIN_N else 'upper')
        self.engine, self.mesh = engine, mesh
        self.N, self.block = int(N), int(block)
        self.dtype = _torch_dtype(FLOAT() if dtype is None else dtype)
        if engine == 'upper':
            self.plan = self._ops = None
            self.device = compute_device() if _is_mesh(mesh) else mesh
        else:
            from romcomma_tpu_torch.parallel.cyclic_deferred import DeferredEngine
            self.plan = plan(self.N, S, self.block)
            self._ops = (CyclicEngine(self.plan, mesh) if engine == 'cyclic' else
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
        working dtype: in the original row order on 'upper', in stored order
        (Npad rows, the same on every rank) on the other engines. Each call takes
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
        noise; -inf where the factorization breaks down. On 'upper' in
        x_dev's dtype; on 'cyclic' and 'cyclic2' on one device in float64,
        the gradient in x_dev's dtype, and over several ranks in x_dev's
        dtype (``MeshLML``).
        There y_dev is one staged column (Npad, 1), and the value and its
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
        engine run on float64 inputs: one (Npad, Npad) float64 buffer on one
        device, the gram factorized in place."""
        x64 = x_dev.to(torch.float64)
        ls, s2, noise = (v.detach() for v in self._cast(x64, ls, s2, noise))
        return self._ops.chol(self._ops.gram(x64, ls, s2, noise))

    def posterior_alpha(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alpha = K^-1 y, its float64 Cholesky factor), float64. On
        'upper' alpha is (N, R) for y_dev (N,) | (N, R), and the factor (N, N),
        both in the original row order. On 'cyclic' and 'cyclic2', as
        romcomma_tpu: alpha (Npad, R) in stored order, the same on every rank,
        and this rank's rows of the engine's float64 factor. romcomma_tpu's ``refine`` rounds repair a float32
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
        ``ls`` (L, M) with s2 and noise (L,) and y_dev's L columns -> a list,
        one structure per output, from ONE stacked pass over the outputs
        (``_sobol_indices_multi``, ``_sobol_indices_multi_error``, as
        romcomma_tpu routes them). ``X`` is the float64 input the calibrator
        sees (the host data). ``n_chunk`` sets the calibrator's chunk.

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
        options = dict(kind=kind, n_chunk=n_chunk, args_fetch=args_fetch)
        if ls_arr.ndim == 1:
            return self._sobol_indices_one(ls_arr, s2, noise, x_dev, y_dev, X, error=error,
                                           is_T_partial=is_T_partial, **options)
        s2_arr, noise_arr = (np.reshape(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                                        ls_arr.shape[0]) for v in (s2, noise))
        if error:
            return self._sobol_indices_multi_error(ls_arr, s2_arr, noise_arr, x_dev, y_dev, X,
                                                   is_T_partial=is_T_partial, **options)
        return self._sobol_indices_multi(ls_arr, s2_arr, noise_arr, x_dev, y_dev, X, **options)

    def _alpha(self, ls, s2, noise, x_dev: torch.Tensor, y_dev: torch.Tensor, l: int
               ) -> torch.Tensor:
        """Output l's float64 K^-1 y in the original row order, (N, 1); its
        factor is dropped here."""
        alpha, _ = self.posterior_alpha(ls, s2, noise, x_dev, y_dev[:, l:l + 1])
        return alpha if self.plan is None else _from_stored_t(self.plan, alpha)

    def _gsa_on_mesh(self, cals: list) -> list:
        """The calibrators, their sweeps spread over the ranks of this
        engine's ('n',) mesh (``gsa.mesh``) where it has one."""
        if self.plan is not None and _is_mesh(self.mesh):
            for cal in cals:
                cal.gsa_mesh = self.mesh
        return cals

    def _agree(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's t on every rank of a mesh; t itself on one device."""
        return t if self.plan is None else self._ops.ring.agree(t)

    def _sobol_indices_multi(self, ls: np.ndarray, s2: np.ndarray, noise: np.ndarray,
                             x_dev: torch.Tensor, y_dev: torch.Tensor, X, kind, n_chunk,
                             args_fetch: float) -> list:
        """Several outputs' indices without errors (romcomma_tpu's,
        ``distributed.py:1569``): each output's float64 posterior solve, one
        at a time, then ONE interval pass for them all
        (``calibrators.marginalize_intervals_stacked``)."""
        from romcomma_tpu_torch.gsa.calibrators import (ClosedSobol, _synchronize,
                                                        marginalize_intervals_stacked)
        kinds = (kind,) if isinstance(kind, str) else tuple(kind)
        (outputs, M), N = ls.shape, self.N
        meta = {} if n_chunk is None else {'n_chunk': n_chunk}
        t0 = time.perf_counter()
        alphas = [self._alpha(ls[l], s2[l], noise[l], x_dev, y_dev, l) for l in range(outputs)]
        _synchronize(alphas[-1])
        t_posterior = time.perf_counter() - t0
        t0 = time.perf_counter()
        flat = [(0, M)] + [s for k in kinds for s in FAMILIES[k](M)]
        with pinned_device(self.device):
            cals = self._gsa_on_mesh([ClosedSobol.from_arrays(
                F=np.asarray([[s2[l]]]), K_cho=torch.zeros((1, 1, 1), dtype=torch.float64,
                                                            device=self.device),
                K_inv_Y=alphas[l].T.reshape(1, 1, N), Lambda=ls[l][None, :], X=X,
                is_F_diagonal=True, L=1, M=M, N=N, **meta) for l in range(outputs)])
            V_cols = [self._agree(out['V'])[0, 0].cpu().numpy()
                      for out in marginalize_intervals_stacked(cals, tuple(flat))]
        self.last_gsa_timings = {'posterior_s': t_posterior,
                                 'intervals_s': time.perf_counter() - t0,
                                 'args_fetch_s': args_fetch, 'outputs': outputs}
        return [self._kinds_from_V(V, kinds, M, kind) for V in V_cols]

    def _psi_half_solvers(self, ls: np.ndarray, s2: np.ndarray, noise: np.ndarray,
                          x_dev: torch.Tensor, seconds: Dict[str, float]) -> list:
        """One psi half solver per output for ``factorized_errors._psi_solve``,
        each building its output's float64 factor at its first call. The
        outputs share one slot: building a factor drops the one before, so the
        stacked error GSA holds one float64 (Npad, Npad) factor at a time, as
        romcomma_tpu's lazy ``psi_solver_factory`` does (``distributed.py:1730-1737``).
        The seconds spent factorizing add up in ``seconds['k_cho_s']``."""
        from romcomma_tpu_torch.gsa.factorized_errors import _psi_solve
        slot: Dict[str, object] = {}

        def solver(l: int):
            def half(factor: torch.Tensor) -> torch.Tensor:
                if slot.get('output') != l:
                    slot.clear()
                    t0 = time.perf_counter()
                    slot['output'], slot['chol'] = l, (
                        self._factor64 if self.plan is None else self._mesh_factor64)(
                        ls[l], s2[l], noise[l], x_dev)
                    seconds['k_cho_s'] += time.perf_counter() - t0
                chol = slot['chol']
                return (_psi_solve(chol[None], factor) if self.plan is None else
                        self._half_solver(chol)(factor))
            return half

        return [solver(l) for l in range(ls.shape[0])]

    def _sobol_indices_multi_error(self, ls: np.ndarray, s2: np.ndarray, noise: np.ndarray,
                                   x_dev: torch.Tensor, y_dev: torch.Tensor, X, kind, n_chunk,
                                   is_T_partial: bool, args_fetch: float) -> list:
        """Several outputs' indices with W/T errors (romcomma_tpu's,
        ``distributed.py:1666``): each output's float64 posterior solve, one
        at a time, then ONE stacked V pass and ONE stacked W/T sweep
        (``calibrators.marginalize_intervals_error_stacked``), each output's
        psi factors half-solved against its own float64 factor, rebuilt one
        output at a time (``_psi_half_solvers``)."""
        from romcomma_tpu_torch.gsa.calibrators import (ClosedSobolWithError, _synchronize,
                                                        marginalize_intervals_error_stacked)
        t_start = time.perf_counter()
        kinds = (kind,) if isinstance(kind, str) else tuple(kind)
        (outputs, M), N = ls.shape, self.N
        meta = {'is_T_partial': bool(is_T_partial)} | (
            {} if n_chunk is None else {'n_chunk': n_chunk})
        t0 = time.perf_counter()
        alphas = [self._alpha(ls[l], s2[l], noise[l], x_dev, y_dev, l) for l in range(outputs)]
        _synchronize(alphas[-1])
        t_posterior = time.perf_counter() - t0
        seconds = {'k_cho_s': 0.0}
        solvers = self._psi_half_solvers(ls, s2, noise, x_dev, seconds)
        t0 = time.perf_counter()
        flat = [(0, M)] + [s for k in kinds for s in FAMILIES[k](M)]
        with pinned_device(self.device):
            cals = self._gsa_on_mesh([ClosedSobolWithError.from_arrays(
                F=np.asarray([[s2[l]]]), K_cho=torch.zeros((1, 1, 1), dtype=torch.float64,
                                                            device=self.device),
                K_inv_Y=alphas[l].T.reshape(1, 1, N), Lambda=ls[l][None, :], X=X,
                is_F_diagonal=True, L=1, M=M, N=N, psi_half_solver=solvers[l], **meta)
                for l in range(outputs)])
            t_setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            outs = [{key: self._agree(out[key])[0, 0].cpu().numpy() for key in ('V', 'T')}
                    for out in marginalize_intervals_error_stacked(cals, tuple(flat))]
        del solvers
        self.last_gsa_timings = {'posterior_s': t_posterior, 'k_cho_s': seconds['k_cho_s'],
                                 'setup_s': t_setup, 'intervals_s': time.perf_counter() - t0,
                                 'args_fetch_s': args_fetch,
                                 'total_s': time.perf_counter() - t_start, 'outputs': outputs}
        self.last_gsa_timings.update({f'iv_{k}': v for k, v in
                                      cals[0].last_interval_timings.items()})
        results = []
        for out in outs:
            T_all = out['T'][1:]
            T_by_kind = {k: {m: float(T_all[i * M + m]) for m in range(M)}
                         for i, k in enumerate(kinds)}
            results.append({'S': self._kinds_from_V(out['V'], kinds, M, kind),
                            'T': T_by_kind[kind] if isinstance(kind, str) else T_by_kind})
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
            self._gsa_on_mesh([cal])
            flat = [(0, M)] + [s for k in kinds for s in FAMILIES[k](M)]
            out = {key: self._agree(value)
                   for key, value in cal.marginalize_intervals(tuple(flat)).items()}
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
        where the factorization breaks down there).

        A one-device 'cyclic' engine of at most DENSE_DIRECT_MAX_N rows takes
        romcomma_tpu's dense direct descent (``distributed.py:1842-1879``):
        ``ExactLML`` on the rows in their original order, and the engine's
        descent only where that one ends on a non-finite LML."""
        x_dev, y_dev = self._device_arrays(X, Y)
        raw0 = self._raw0(x_dev, ls0, s2_0, noise0)
        merge = self._merge(raw0, mask)

        def descent(lml):
            res = lbfgs.minimize(lambda raw: -lml(*self._constrain(merge(raw))), raw0,
                                 maxiter=maxiter, gtol=gtol,
                                 max_linesearch_steps=max_linesearch_steps)
            with torch.no_grad():
                return self._constrain(merge(res.params)), -res.value, res.iterations

        if self.engine == 'cyclic' and self.plan.S == 1 and self.N <= self.DENSE_DIRECT_MAX_N:
            x, y = self._as_working(X), self._as_working(Y).reshape(self.N, -1)[:, :1]
            out = descent(lambda ls, s2, noise: ExactLML.apply(ls, s2, noise, x, y))
            if np.isfinite(out[1]):
                return out
        return descent(lambda ls, s2, noise: self.lml(ls, s2, noise, x_dev, y_dev[:, :1]))

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
