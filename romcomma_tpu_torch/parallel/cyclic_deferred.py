"""The 'cyclic2' engine: two-level deferred-update block-cyclic factorization
over the ranks of an ('n',) mesh.

Counterpart of ``romcomma_tpu/parallel/cyclic_deferred.py``. With
block-cyclic row ownership (global elimination block g on rank g mod S at
local slot g // S), a super panel of P = q S consecutive global blocks is a
contiguous (q B, Npad) row slab on every rank, so the left-looking schedule
distributes:

  - deferred update: each rank applies the super panel's pending update from
    all of its finalized rows as ONE (rows, SB)^T @ (rows, W) product, and
    ONE all_reduce sums the ranks' parts;
  - panel: ONE all_gather replicates the (SB, W) panel slab, every rank
    factors it redundantly (a cuSOLVER Cholesky of its (SB, SB) diagonal
    block and a triangular solve of the rest) and keeps its own q row blocks.

Columns are in GLOBAL elimination order, which is the original data order
(padding at the global tail); rows stay in stored order. The solves' right
sides convert between stored and global order at their boundary
(``DeferredEngine.fwd``/``bwd``), so every stored-order consumer of
``parallel.distributed`` works unchanged.

The backward inverts the factor in place (bottom-up super panels, one
all_gather and one all_reduce each), and the gradient rotates the
V = U^-1 row slabs around the ring: each rank forms its (my rows x src rows)
K^-1 tiles as V_local-chunk @ V_src-chunk^T with the contraction narrowed to
the pair's live columns, rebuilds the matching signal-gram tile through
``ops.gram.rbf_gram`` (on a card, one launch of the unit-gram kernel with
two operands) and accumulates the closed-form reductions of
dLML/dK = (alpha alpha^T - K^-1) / 2; one all_reduce combines the ranks.
romcomma_tpu's precision tiers (CHOL_PRECISION = HIGH, bf16_3x) are not
carried: float32 products stay true float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from romcomma_tpu_torch.ops.gram import rbf_gram
from romcomma_tpu_torch.ops.linalg import cholesky as dense_cholesky
from romcomma_tpu_torch.parallel.distributed import Plan, Ring, ring_tile


def super_q(pl_: Plan, target: int) -> int:
    """Blocks per rank q of one super panel: the largest q with panel width
    q S B <= target (q = 1 always qualifies). q need not divide c: the last
    super panel is a partial tail (super_sizes)."""
    return max(1, min(pl_.c, max(target, pl_.S * pl_.B) // (pl_.S * pl_.B)))


def super_sizes(pl_: Plan, q: int) -> List[int]:
    """Per-panel blocks per rank [q, q, ..., tail] covering c exactly."""
    NS = -(-pl_.c // q)
    sizes = [q] * (NS - 1) + [pl_.c - (NS - 1) * q]
    assert sizes[-1] >= 1 and sum(sizes) == pl_.c
    return sizes


def stored_global_perms(pl_: Plan) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv): perm[stored_row] = global_row; inv[global_row] = stored."""
    perm = np.asarray(pl_.perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return perm, inv


def _local_global_rows(pl_: Plan, me: int, device) -> torch.Tensor:
    """Global row of each of rank me's (c B) stored rows."""
    ci = torch.arange(pl_.c, device=device)
    return ((ci * pl_.S + me)[:, None] * pl_.B
            + torch.arange(pl_.B, device=device)[None, :]).reshape(-1)


def _panel(ring: Ring, mine: torch.Tensor, q_s: int, B: int) -> torch.Tensor:
    """The super panel's rows in global order from every rank's q_s row
    blocks (qB_s, W): one all_gather."""
    S, W = ring.S, mine.shape[1]
    return ring.gather(mine).reshape(S, q_s, B, W).transpose(0, 1).reshape(q_s * S * B, W)


def _keep_mine(ring: Ring, panel: torch.Tensor, q_s: int, B: int) -> torch.Tensor:
    """This rank's q_s row blocks (qB_s, W) of a panel in global order."""
    W = panel.shape[1]
    return panel.reshape(q_s, ring.S, B, W)[:, ring.me].reshape(q_s * B, W)


def ring_gram_global(pl_: Plan, mesh):
    """Noisy gram, rows block-cyclic (stored order), columns GLOBAL order.

    fn(x_stored (Npad, M), the same on every rank, ls, s2, noise,
    dtype=None) -> this rank's rows (c B, Npad) in ``dtype`` (x_stored's by
    default; the tiles in x_stored's, the noise added in ``dtype``). Padding
    rows and columns (global index >= N) carry a unit diagonal and zeros
    off it."""
    ring = Ring(mesh)
    S, B, c, Npad, N = pl_.S, pl_.B, pl_.c, pl_.Npad, pl_.N
    cB = c * B

    def build(x_stored, ls, s2, noise, dtype=None):
        me = ring.me
        x_local = x_stored[me * cB:(me + 1) * cB].contiguous()
        if S == 1:
            # One rank: stored order is global order, and the one tile is the
            # whole gram (no second (Npad, Npad) buffer).
            out = ring_tile(x_local, x_local, ls, s2, dtype)
        else:
            out = torch.empty((cB, c, S, B), dtype=dtype or x_stored.dtype,
                              device=x_stored.device)
            buf = x_local
            for s in range(S):
                src = (me - s) % S
                # buf's stored rows (ci, b) of rank src are global columns of block ci S + src
                out[:, :, src, :] = ring_tile(x_local, buf, ls, s2).view(cB, c, B)
                if s + 1 < S:
                    buf = ring.shift(buf)
        out = out.view(cB, Npad)
        g_rows = _local_global_rows(pl_, me, out.device)
        row_real = (g_rows < N).to(out.dtype)
        out.mul_(row_real[:, None]).mul_((torch.arange(Npad, device=out.device) < N).to(out.dtype))
        out[torch.arange(cB, device=out.device), g_rows] += torch.where(row_real > 0, noise, 1.0)
        return out

    return build


def cholesky_deferred(pl_: Plan, mesh, super_block: int = 3584):
    """Distributed two-level left-looking UPPER Cholesky, K = U^T U.

    fn(K rows, global columns) -> U rows (strict lower zero, padding
    diagonal 1), in place. Per super panel: one deferred-update product and
    one all_reduce, one all_gather of the panel, its redundant factorization.
    A panel that breaks down gives NaN, as ops.linalg.cholesky does."""
    ring = Ring(mesh)
    S, B, Npad = pl_.S, pl_.B, pl_.Npad
    q = super_q(pl_, super_block)
    sizes = super_sizes(pl_, q)

    def factor(K_local):
        A = K_local
        for s, q_s in enumerate(sizes):
            lo, qB_s, SB_s, S0 = s * q * B, q_s * B, q_s * S * B, s * q * S * B
            # deferred update from all finalized local rows, summed over ranks
            update = A[:lo, S0:S0 + SB_s].T @ A[:lo, S0:] if s > 0 else torch.zeros(
                (SB_s, Npad - S0), dtype=A.dtype, device=A.device)
            update = ring.psum(update)
            slab = _panel(ring, A[lo:lo + qB_s, S0:], q_s, B) - update
            U_ss = dense_cholesky(slab[:, :SB_s]).mT
            panel = torch.cat([U_ss, torch.linalg.solve_triangular(
                U_ss.mT, slab[:, SB_s:], upper=False)], dim=1)
            A[lo:lo + qB_s, :S0] = 0.0
            A[lo:lo + qB_s, S0:] = _keep_mine(ring, panel, q_s, B)
        return A

    return factor


def invert_deferred(pl_: Plan, mesh, super_block: int = 3584):
    """V = U^-1 over the ranks, bottom-up super panels, in place.

    fn(U rows, global columns) -> V rows. Per super panel: ONE all_gather of
    the panel's U rows, a redundant inverse of its (SB, SB) diagonal block,
    each rank's part of U[panel, >panel] V[>panel, :] as one product and ONE
    all_reduce: the Schur form of romcomma_tpu's in-place inverse."""
    ring = Ring(mesh)
    S, B, c, Npad = pl_.S, pl_.B, pl_.c, pl_.Npad
    q = super_q(pl_, super_block)
    sizes = super_sizes(pl_, q)

    def invert(U_local):
        A, me = U_local, ring.me
        for s in range(len(sizes) - 1, -1, -1):
            q_s = sizes[s]
            lo, qB_s, SB_s, S0 = s * q * B, q_s * B, q_s * S * B, s * q * S * B
            S1 = S0 + SB_s
            c_below = c - (s * q + q_s)                  # local blocks below the panel
            slab = _panel(ring, A[lo:lo + qB_s, S0:], q_s, B)
            eye = torch.eye(SB_s, dtype=A.dtype, device=A.device)
            V_ss = torch.linalg.solve_triangular(slab[:, :SB_s], eye, upper=True)
            if S1 < Npad:
                # the panel's U columns of MY rows below it: the (ci, d, b)
                # view of the slab's columns past the panel, at d = me
                Uc = slab[:, SB_s:].reshape(SB_s, c_below, S, B)[:, :, me].reshape(SB_s, -1)
                T = ring.psum(Uc @ A[lo + qB_s:, S1:])
                V_panel = torch.cat([V_ss, -(V_ss @ T)], dim=1)
            else:
                V_panel = V_ss
            A[lo:lo + qB_s, :S0] = 0.0
            A[lo:lo + qB_s, S0:] = _keep_mine(ring, V_panel, q_s, B)
        return A

    return invert


def solve_forward_global(pl_: Plan, mesh):
    """fn(U rows, Y (Npad, R) in GLOBAL order, the same on every rank) -> Z
    with U^T Z = Y. Per block k every rank contracts its own column block
    against the solved prefix (unsolved rows read Z = 0), and ONE all_reduce
    sums the parts beside the owner's diagonal block."""
    ring = Ring(mesh)
    S, B, c, NB = pl_.S, pl_.B, pl_.c, pl_.NB

    def solve(U_local, Y):
        me, R = ring.me, Y.shape[1]
        Z = torch.zeros_like(Y)
        Zm = Z.view(c, S, B, R)[:, me]                   # my rows of Z, a view
        for k in range(NB):
            col0 = k * B
            pack = torch.zeros((B, R + B), dtype=Y.dtype, device=Y.device)
            pack[:, :R] = U_local[:, col0:col0 + B].T @ Zm.reshape(c * B, R)
            if me == k % S:
                pack[:, R:] = U_local[(k // S) * B:(k // S + 1) * B, col0:col0 + B]
            pack = ring.psum(pack)
            Z[col0:col0 + B] = torch.linalg.solve_triangular(
                pack[:, R:].mT, Y[col0:col0 + B] - pack[:, :R], upper=False)
        return Z

    return solve


def solve_backward_global(pl_: Plan, mesh):
    """fn(U rows, Z (Npad, R) in GLOBAL order, the same on every rank) -> W
    with U W = Z: per block, its owner forms the right side and broadcasts
    it with its diagonal block."""
    ring = Ring(mesh)
    S, B, NB = pl_.S, pl_.B, pl_.NB

    def solve(U_local, Z):
        R = Z.shape[1]
        W = torch.zeros_like(Z)
        for i in range(NB):
            k = NB - 1 - i
            col0 = k * B
            pack = torch.empty((B, R + B), dtype=Z.dtype, device=Z.device)
            if ring.me == k % S:
                slab = U_local[(k // S) * B:(k // S + 1) * B]
                pack[:, :R] = slab[:, col0 + B:] @ W[col0 + B:]
                pack[:, R:] = slab[:, col0:col0 + B]
            pack = ring.from_rank(pack, k % S)
            W[col0:col0 + B] = torch.linalg.solve_triangular(
                pack[:, R:], Z[col0:col0 + B] - pack[:, :R], upper=True)
        return W

    return solve


def log_diag_sum_global(pl_: Plan, mesh):
    """fn(U rows) -> sum(log diag(U)); padding rows carry diag 1."""
    ring = Ring(mesh)
    S, B, c = pl_.S, pl_.B, pl_.c

    def logdiag(U_local):
        acc = torch.zeros((), dtype=U_local.dtype, device=U_local.device)
        for ci in range(c):
            col0 = (ci * S + ring.me) * B
            acc = acc + torch.sum(torch.log(torch.diagonal(
                U_local[ci * B:(ci + 1) * B, col0:col0 + B])))
        return ring.psum(acc)

    return logdiag


def grads_ring_pairs(pl_: Plan, mesh, super_block: int = 3584):
    """The streamed LML gradient from the distributed triangular inverse:
    fn(V rows, alpha (Npad, 1) in GLOBAL order, x_stored (Npad, M), the same
    on every rank, ls, s2, noise) -> (dls, ds2, dnoise), unscaled (the
    caller divides dls by ls^3 and ds2 by s2).

    The half-ring sweep, as romcomma_tpu's: W = Bbar o K is symmetric, so only
    ring offsets 0..S//2 run. Offset 0 takes unordered chunk pairs, the
    off-diagonal ones at weight 2; offsets 1..ceil(S/2)-1 carry each
    unordered rank pair once at weight 2; for even S the antipodal offset
    S/2 is taken by both ends at weight 1. The tail chunk is clamped to the
    slab's end and its overlap with the chunk before it masked to zero. The
    gram tiles are built in x's dtype (float32 on a card: the kernel) and the
    rest in V's, which may be wider."""
    ring = Ring(mesh)
    S, B, c, Npad, N = pl_.S, pl_.B, pl_.c, pl_.Npad, pl_.N
    cB = c * B
    q = super_q(pl_, super_block)
    SB, NS, qB = q * S * B, -(-c // q), q * B

    def grads(V_local, alpha_g, x_stored, ls, s2, noise):
        me, dt, dev = ring.me, V_local.dtype, V_local.device
        M = x_stored.shape[1]
        x_local = x_stored[me * cB:(me + 1) * cB].contiguous()
        arange_q = torch.arange(qB, device=dev)

        def chunk(V_slab, x_slab, a_slab, rank, si):
            r0 = min(si * qB, (c - q) * B)
            ci = r0 // B + torch.arange(q, device=dev)
            g_rows = ((ci * S + rank)[:, None] * B
                      + torch.arange(B, device=dev)[None, :]).reshape(-1)
            fresh = (r0 + arange_q) >= si * qB
            return (V_slab[r0:r0 + qB], x_slab[r0:r0 + qB], a_slab[r0:r0 + qB, 0], g_rows,
                    ((g_rows < N) & fresh).to(dt))

        def alpha_of(rank):
            return alpha_g.view(c, S, B, 1)[:, rank].reshape(cB, 1)

        acc = torch.zeros(M + 2, dtype=dt, device=dev)      # dls, ds2, dnoise

        def pair(sr, sc, V_buf, x_buf, a_buf, src, weight):
            Vr, xr, ar, gr, mr = chunk(V_local, x_local, a_mine, me, sr)
            Vc, xc, ac, gc, mc = chunk(V_buf, x_buf, a_buf, src, sc)
            start = max(sr, sc) * SB                     # columns < start are zero in one
            kinv = Vr[:, start:] @ Vc[:, start:].T
            mask2 = mr[:, None] * mc[None, :]
            Bbar = 0.5 * (ar[:, None] * ac[None, :] - kinv) * mask2
            W = Bbar * (rbf_gram(xr, xc, ls, s2).to(dt) * mask2)
            xr, xc = xr.to(dt), xc.to(dt)           # the reductions in V's dtype
            acc[M] += weight * torch.sum(W)
            if src == me:                                # true diagonal entries
                acc[M + 1] += torch.sum(Bbar * (gr[:, None] == gc[None, :]))
            acc[:M] += weight * ((xr * xr).T @ torch.sum(W, dim=1)
                                 + (xc * xc).T @ torch.sum(W, dim=0)
                                 - 2.0 * torch.sum(xr * (W @ xc), dim=0))

        a_mine = alpha_of(me)
        V_buf, x_buf = V_local, x_local
        for step in range(S // 2 + 1):
            src = (me - step) % S
            a_buf = alpha_of(src)
            if step == 0:
                for sc in range(NS):
                    for sr in range(sc + 1):
                        pair(sr, sc, V_buf, x_buf, a_buf, src, 1.0 if sr == sc else 2.0)
            else:
                weight = 1.0 if (S % 2 == 0 and step == S // 2) else 2.0
                for sr in range(NS):
                    for sc in range(NS):
                        pair(sr, sc, V_buf, x_buf, a_buf, src, weight)
            if step < S // 2:
                V_buf, x_buf = ring.shift(V_buf), ring.shift(x_buf)
        acc = ring.psum(acc)
        return acc[:M], acc[M], acc[M + 1]

    return grads


class DeferredEngine:
    """The 'cyclic2' bundle that DistributedGP plugs in. Its solves speak the
    STORED order of parallel.distributed at their boundary (one row
    permutation of the right side each way)."""

    def __init__(self, pl_: Plan, mesh, super_block: int):
        self.plan, self.ring = pl_, Ring(mesh)
        self.q = super_q(pl_, super_block)
        perm, inv = stored_global_perms(pl_)
        self._perm = torch.as_tensor(perm, device=self.ring.device)
        self._inv = torch.as_tensor(inv, device=self.ring.device)
        self.gram = ring_gram_global(pl_, mesh)
        self.chol = cholesky_deferred(pl_, mesh, super_block)
        self.inv = invert_deferred(pl_, mesh, super_block)
        self._fwd = solve_forward_global(pl_, mesh)
        self._bwd = solve_backward_global(pl_, mesh)
        self.logdiag = log_diag_sum_global(pl_, mesh)
        self._grads = grads_ring_pairs(pl_, mesh, super_block)

    def fwd(self, U, Y):
        """U^T Z = Y, Y and Z in stored order."""
        return self._fwd(U, Y[self._inv.to(Y.device)])[self._perm.to(Y.device)]

    def bwd(self, U, Z):
        """U W = Z, Z and W in stored order."""
        return self._bwd(U, Z[self._inv.to(Z.device)])[self._perm.to(Z.device)]

    def residual(self, U_local: torch.Tensor) -> torch.Tensor:
        """What the backward keeps of the forward: V = U^-1, inverted in place."""
        return self.inv(U_local)

    def grads(self, V, alpha_stored, x_stored, ls, s2, noise):
        """(dls, ds2, dnoise), scaled (dls / ls^3, ds2 / s2)."""
        dls, ds2, dnoise = self._grads(V, alpha_stored[self._inv], x_stored, ls, s2, noise)
        return dls / ls ** 3, ds2 / s2, dnoise
