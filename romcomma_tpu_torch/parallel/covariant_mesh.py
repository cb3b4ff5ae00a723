"""The covariant MOGP's (L N, L N) chain over the ranks of an ('n',) mesh, on
the 'cyclic2' engine.

Counterpart of ``romcomma_tpu/parallel/covariant_mesh.py``. The covariant
gram is one more SPD matrix, so ``cyclic_deferred.DeferredEngine`` factors,
solves and inverts it unchanged; only the gram's assembly and the
(dF, dnoise_cov) gradient know its structure.

Layout: global row i = l N + n (the ``Y.T.reshape`` order of the one-device
chain, ``models.gp.CovariantUpperLML``), staged into the block-cyclic stored
order of ``parallel.distributed.plan(L N, S, B)``. Each row carries its
scaled coordinates u_i = x_{n_i} / lambda_{l_i} (the lengthscales are frozen
on this route, so u never changes during a descent), a one-hot output row
O_i and its sample index n_i. A tile of rows i against columns j is

    K[i, j] = unit(u_i, u_j) F[l_i, l_j] + delta(n_i == n_j) noise_cov[l_i, l_j]

with the unit gram from ``ops.gram.rbf_gram`` (on a card in float32, one
launch of the unit-gram kernel: the ring's tiles, and the gradient's pair
tiles with two operands), F[l_i, l_j] picked exactly by one-hot products
(float32 products are true float32 here, ``base.definitions``), and the
noise term added at the L global columns l N + n_i of each real row i
alone. The gradient is dF = O^T (Bbar o unit) O and dnoise = O^T (Bbar o
delta_n) O with Bbar = (alpha alpha^T - K^-1) / 2, streamed through the
half-ring pair-tile schedule of ``cyclic_deferred.grads_ring_pairs``: an
unordered pair of tiles contributes T + T^T (its mirrored block is the
transpose), the matrix form of that sweep's weight 2.

As in the variant engines, every rank holds the staged arrays whole
(stored order) and its own (c B, Npad) row slab of K; the LML and its
gradient are rank 0's on every rank, so descents run in lockstep.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from romcomma_tpu_torch.base.definitions import FLOAT
from romcomma_tpu_torch.ops import lbfgs
from romcomma_tpu_torch.ops.gram import rbf_gram
from romcomma_tpu_torch.parallel.cyclic_deferred import (DeferredEngine, _local_global_rows,
                                                         super_q)
from romcomma_tpu_torch.parallel.distributed import (MULTI_DEVICE_MESH, DistributedGP, Plan, Ring,
                                                     _is_mesh, _to_stored_t, _torch_dtype,
                                                     make_n_mesh, plan)

#: L*N from which a covariant descent on several ranks takes this mesh, as in
#: romcomma_tpu: below it sharding gains nothing and the block-cyclic plan
#: is mostly padding.
COVARIANT_MESH_MIN_LN: int = 4096
#: Rows of a ring tile whose F picks are formed at once: a (PICK_ROWS, c B)
#: temporary instead of one the size of the tile.
PICK_ROWS: int = 2048


class CovariantStage(NamedTuple):
    """The staged inputs of the chain, in stored order, the same on every rank."""
    u: torch.Tensor       # (Npad, M) scaled coordinates x_n / lambda_l
    O: torch.Tensor       # (Npad, L) one-hot output index, zero on padding rows
    ns: torch.Tensor      # (Npad,) sample index n, -1 on padding rows
    y: torch.Tensor       # (Npad, 1) outputs, Y.T.reshape(L N, 1)


def _slab(t: torch.Tensor, me: int, cB: int) -> torch.Tensor:
    return t[me * cB:(me + 1) * cB].contiguous()


def ring_gram_global_covariant(pl_: Plan, mesh, N: int):
    """The covariant gram, rows in stored order on their ranks, columns in
    GLOBAL order: the 'cyclic2' engine's input, as ``ring_gram_global``.

    fn(stage, F, noise_cov) -> this rank's rows (c B, Npad). The u and O
    slabs rotate around the ring; each tile is one unit gram times the picked
    F. Padding rows and columns are zeroed, real rows get their noise terms,
    then padding rows their unit diagonal."""
    ring = Ring(mesh)
    S, B, c, Npad, LN = pl_.S, pl_.B, pl_.c, pl_.Npad, pl_.N
    cB = c * B

    def build(st: CovariantStage, F: torch.Tensor, noise_cov: torch.Tensor) -> torch.Tensor:
        me, dt, dev = ring.me, st.u.dtype, st.u.device
        u_local, O_local, ns_local = (_slab(t, me, cB) for t in (st.u, st.O, st.ns))
        L = O_local.shape[1]
        one = torch.ones((), dtype=dt, device=dev)
        OF = O_local @ F                                 # row i: F[l_i, :], exactly
        out = None if S == 1 else torch.empty((cB, c, S, B), dtype=dt, device=dev)
        bu, bO = u_local, O_local
        for s in range(S):
            src = (me - s) % S                           # owner of the visiting rows
            tile = rbf_gram(u_local, bu, one, one)
            for r0 in range(0, cB, PICK_ROWS):
                tile[r0:r0 + PICK_ROWS].mul_(OF[r0:r0 + PICK_ROWS] @ bO.T)
            if S == 1:
                out = tile
            else:                                        # bu's rows (ci, b): block ci S + src
                out[:, :, src, :] = tile.view(cB, c, B)
            if s + 1 < S:
                bu, bO = ring.shift(bu), ring.shift(bO)
        out = out.view(cB, Npad)
        g_rows = _local_global_rows(pl_, me, dev)
        real = g_rows < LN
        pad = torch.nonzero(~real).squeeze(1)
        rows = torch.nonzero(real).squeeze(1)
        out[pad] = 0.0
        out[:, LN:] = 0.0
        cols = ns_local[rows, None] + N * torch.arange(L, device=dev)[None, :]
        out[rows[:, None], cols] += O_local[rows] @ noise_cov
        out[pad, g_rows[pad]] = 1.0
        return out

    return build


def grads_ring_pairs_covariant(pl_: Plan, mesh, super_block: int = 3584):
    """The streamed (dF, dnoise_cov) of the LML from the in-place inverse:
    fn(V rows, alpha (Npad, 1) in GLOBAL order, stage) -> ((L, L), (L, L)),
    every rank's part summed.

    The half-ring schedule of ``cyclic_deferred.grads_ring_pairs``: ring
    offset 0 takes this rank's unordered chunk pairs, offsets 1..S//2 the
    visiting rank's every pair (for even S the antipodal offset is taken by
    both ends); the tail chunk is clamped to the slab's end and its overlap
    with the chunk before it masked. A tile T of an unordered pair adds
    T + T^T, of a pair counted once (a diagonal chunk pair, the antipodal
    offset) T alone."""
    ring = Ring(mesh)
    S, B, c, LN = pl_.S, pl_.B, pl_.c, pl_.N
    cB = c * B
    q = super_q(pl_, super_block)
    SB, NS, qB = q * S * B, -(-c // q), q * B

    def grads(V_local: torch.Tensor, alpha_g: torch.Tensor, st: CovariantStage
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        me, dt, dev = ring.me, V_local.dtype, V_local.device
        u_local, O_local, ns_local = (_slab(t, me, cB) for t in (st.u, st.O, st.ns))
        L = O_local.shape[1]
        one = torch.ones((), dtype=dt, device=dev)
        arange_q = torch.arange(qB, device=dev)

        def chunk(V_slab, u_slab, O_slab, ns_slab, a_slab, rank, si):
            r0 = min(si * qB, (c - q) * B)
            ci = r0 // B + torch.arange(q, device=dev)
            g_rows = ((ci * S + rank)[:, None] * B
                      + torch.arange(B, device=dev)[None, :]).reshape(-1)
            fresh = (r0 + arange_q) >= si * qB
            rows = slice(r0, r0 + qB)
            return (V_slab[rows], u_slab[rows], O_slab[rows], ns_slab[rows], a_slab[rows, 0],
                    ((g_rows < LN) & fresh).to(dt))

        def alpha_of(rank):
            return alpha_g.view(c, S, B, 1)[:, rank].reshape(cB, 1)

        acc = torch.zeros((2, L, L), dtype=dt, device=dev)      # dF, dnoise

        def pair(sr, sc, bufs, src, weight):
            Vr, ur, Or, nr, ar, mr = chunk(V_local, u_local, O_local, ns_local, a_mine, me, sr)
            Vc, uc, Oc, nc, ac, mc = chunk(*bufs, src, sc)
            start = max(sr, sc) * SB                     # columns < start are zero in one
            kinv = Vr[:, start:] @ Vc[:, start:].T
            Bbar = 0.5 * (ar[:, None] * ac[None, :] - kinv) * (mr[:, None] * mc[None, :])
            T = torch.stack([Or.T @ ((Bbar * rbf_gram(ur, uc, one, one)) @ Oc),
                             Or.T @ ((Bbar * (nr[:, None] == nc[None, :])) @ Oc)])
            acc.add_(T + (weight - 1.0) * T.mT)

        a_mine = alpha_of(me)
        bufs = (V_local, u_local, O_local, ns_local)
        for step in range(S // 2 + 1):
            src = (me - step) % S
            if step == 0:
                for sc in range(NS):
                    for sr in range(sc + 1):
                        pair(sr, sc, bufs + (alpha_of(src),), src, 1.0 if sr == sc else 2.0)
            else:
                weight = 1.0 if (S % 2 == 0 and step == S // 2) else 2.0
                for sr in range(NS):
                    for sc in range(NS):
                        pair(sr, sc, bufs + (alpha_of(src),), src, weight)
            if step < S // 2:
                bufs = tuple(ring.shift(b) for b in bufs)
        acc = ring.psum(acc)
        return acc[0], acc[1]

    return grads


class CovariantMeshLML(torch.autograd.Function):
    """lml(F, noise_cov) of the staged chain, with romcomma_tpu's custom VJP:
    forward gram, factor, solve and log-det; where a gradient is wanted, the
    factor inverted in place (the backward's one residual besides alpha),
    then the pair sweep. The value and the gradient are rank 0's on every
    rank; -inf where the factorization breaks down."""

    @staticmethod
    def forward(ctx, F, noise_cov, gp, st, keep):
        eng = gp.engine
        U = eng.chol(gp._gram(st, F, noise_cov))
        z = eng.fwd(U, st.y)
        value = (-0.5 * torch.sum(z * z) - eng.logdiag(U)
                 - 0.5 * gp.plan.N * math.log(2.0 * math.pi))
        value = eng.ring.agree(torch.where(torch.isfinite(value), value, -torch.inf))
        if keep:
            alpha = eng.bwd(U, z)
            ctx.save_for_backward(eng.residual(U), alpha)
        ctx.gp, ctx.st = gp, st
        return value

    @staticmethod
    def backward(ctx, gbar):
        V, alpha = ctx.saved_tensors
        gp = ctx.gp
        dF, dnoise = gp._grads(V, alpha[gp.engine._inv], ctx.st)
        packed = gp.engine.ring.agree(torch.stack([dF, dnoise]))
        return gbar * packed[0], gbar * packed[1], None, None, None


class DistributedCovariantGP:
    """The covariant counterpart of ``DistributedGP``'s 'cyclic2' engine: a
    plan over L N rows, the deferred engine, one LML over (F, noise_cov)
    with the lengthscales frozen, and its descent."""

    def __init__(self, N: int, L: int, mesh=None, block: int = 256, dtype=None,
                 super_block: Optional[int] = None):
        """``mesh``: an ('n',) ``DeviceMesh`` (None: ``make_n_mesh()``); the
        engine runs over ranks, so a plain device is refused. ``dtype``: the
        working dtype (None: FLOAT())."""
        mesh = make_n_mesh() if mesh is None else mesh
        if not _is_mesh(mesh):
            raise ValueError(f'DistributedCovariantGP runs over a mesh: {MULTI_DEVICE_MESH}.')
        self.N, self.L, self.mesh = int(N), int(L), mesh
        self.plan = plan(self.L * self.N, S=mesh.size(), B=block)
        self.dtype = _torch_dtype(FLOAT() if dtype is None else dtype)
        self.super_block = (DistributedGP.DENSE_SUPER_BLOCK if super_block is None
                            else super_block)
        self.engine = DeferredEngine(self.plan, mesh, self.super_block)
        self.device = self.engine.ring.device
        self._gram = ring_gram_global_covariant(self.plan, mesh, self.N)
        self._grads = grads_ring_pairs_covariant(self.plan, mesh, self.super_block)

    _as_working = DistributedGP._as_working       # reads self.device and self.dtype

    def stage(self, X, Y, lengthscales) -> CovariantStage:
        """X (N, M), Y (N, L) and the frozen lengthscales (L, M), host arrays
        or tensors, as the staged chain on this rank's device, in the
        working dtype (ns int64)."""
        N, L = self.N, self.L
        X, ls = self._as_working(X), self._as_working(lengthscales).reshape(L, -1)
        u = (X[None, :, :] / ls[:, None, :]).reshape(L * N, -1)
        O = torch.eye(L, dtype=self.dtype, device=self.device).repeat_interleave(N, dim=0)
        ns = torch.arange(N, device=self.device).repeat(L)
        y = self._as_working(Y).reshape(N, L).T.reshape(L * N, 1)
        ns_stored = _to_stored_t(self.plan, ns[:, None] + 1)[:, 0] - 1    # -1 on padding
        return CovariantStage(*(_to_stored_t(self.plan, t) for t in (u, O)), ns_stored,
                              _to_stored_t(self.plan, y))

    def lml_fn(self, st: CovariantStage) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """lml(F, noise_cov) over the staged chain, differentiable in both.
        A call without a gradient to take skips the inverse."""
        def lml(F: torch.Tensor, noise_cov: torch.Tensor) -> torch.Tensor:
            keep = torch.is_grad_enabled() and (F.requires_grad or noise_cov.requires_grad)
            return CovariantMeshLML.apply(F.to(self.dtype), noise_cov.to(self.dtype), self, st,
                                          keep)

        return lml

    def calibrate(self, X, Y, raw, mask, maxiter: int = 5000, gtol: float = 1e-16,
                  ftol: float = lbfgs.SCIPY_FTOL):
        """scipy L-BFGS-B over the covariant raw parameters with the
        lengthscales FROZEN, each evaluation one value and gradient over the
        mesh: romcomma_tpu's ``calibrate_covariant_host`` contract on this
        engine. Every rank runs the descent in lockstep on rank 0's values
        and returns the same bits. Returns (raw params, lml, iterations,
        scipy's reason for stopping), as ``models.gp.calibrate_covariant``."""
        from romcomma_tpu_torch.models.gp import _merge
        from romcomma_tpu_torch.models.params import covariant_constrain
        frozen = {name: value.detach().to(self.dtype) for name, value in raw.items()}
        mask = dict(mask, raw_lengthscales=0.0)
        st = self.stage(X, Y, covariant_constrain(frozen)['lengthscales'])
        lml = self.lml_fn(st)

        def objective(p):
            c = covariant_constrain(_merge(p, frozen, mask))
            return -lml(c['F'], c['noise_cov'])

        res = lbfgs.minimize(objective, frozen, maxiter=maxiter, gtol=gtol, ftol=ftol)
        return _merge(res.params, frozen, mask), -res.value, res.iterations, res.message
