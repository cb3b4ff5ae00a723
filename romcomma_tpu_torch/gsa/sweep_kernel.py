"""The W/T error sweep of one column chunk as one fused float64 Triton kernel.

What it computes: ``factorized_errors._run_chunk``, the plain version, which
stays the CPU path and the kernel's oracle. Each sweep plane, a member's
(r, j, k) or psi's (l, i), is

    d[n, c] = A[m, n] - Q[m, c],    e = d * d,    E = sum of e over the dims swept,

and every emitted kind reduces ``exp(U[m, n] - X)`` (members) or ``exp(-X)``
(psi), X being e (per dim, 'single') or E (a running sum, 'prefix' or
'suffix'), over the rows n against its row weights, giving one column vector
per plane, kind and dim. The prefix-last emission reduces the final carry
once. Everything outside the planes (the q-side weights of the members'
quads, the psi columns' g0 factor, the determinants and the K solve) stays in
``factorized_errors``, on the kernel's columns.

It replaces no Pallas kernel: ``romcomma_tpu/gsa/factorized_errors.py`` runs
this sweep as a ``lax.scan`` of jnp ops, which XLA fuses so that the planes
never leave the chip. Eager PyTorch writes each (N, c) float64 plane to
device memory and reads it back, some 27 passes a dim per chunk, so the plain
version is bound by HBM traffic on planes that never need to exist.

What bounds this kernel is the float64 ``exp``: per element of a plane and
per dim it does a subtract, a square and an add, then for each emitted kind
one full-precision ``exp`` (libdevice ``__nv_exp``, 17 float64
instructions in its PTX; no ``ex2.approx``, no fast math) and one multiply-add, against
the H100's 132 SMs x 64 FP64 lanes. Its design meets that by reading only
O(M N) inputs and writing O(M c) partial sums: each program owns one plane of
one calibrator, one BLOCK_COLS-column tile and one group of rows; it walks its
rows in BLOCK_ROWS-row tiles and, for each, runs the dims in the sweep's
order with the carry E in registers, forms each emitted kind's exp there,
reduces it over the tile's rows and adds the column into its own slot of a
partial-sum array, one slot per row group. The row groups exist to fill the
card when planes x column tiles alone do not; their partials are added by one
``torch.sum`` afterwards. No float atomics: reruns agree bit for bit, and
only the order of the additions over rows and columns differs from the plain
version.

A CPU tensor takes the plain version; a CUDA float64 sweep launches this
kernel, and any other CUDA dtype raises: there is no fallback (``route``).
Triton is imported, and the kernel built, at the first launch, never when
this module is imported; Triton's own cache keeps its compiled variants.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

#: Number of kernel launches made by this process.
LAUNCHES = 0

#: Rows and columns of a program's register tile, and its warps.
BLOCK_ROWS, BLOCK_COLS, WARPS = 16, 32, 2
#: Programs a launch aims for (132 SMs, several resident each, several
#: waves): row groups are added until planes x column tiles x groups reach it.
TARGET_PROGRAMS = 4096

_INT_MAX = 2 ** 31 - 1
_KERNEL = None


def route(device, dtype: torch.dtype) -> str:
    """Which W/T sweep a chunk on ``device`` in ``dtype`` takes: 'torch' (the
    plain ``_run_chunk``) on the CPU, 'kernel' for CUDA float64; raises for
    any other CUDA dtype or device type."""
    device = torch.device(device)
    if device.type == 'cpu':
        return 'torch'
    if device.type != 'cuda':
        raise ValueError(f'W/T sweep: no route for a {device.type} device.')
    if dtype != torch.float64:
        raise TypeError(f'W/T sweep kernel: float64 only, got {dtype}.')
    return 'kernel'


def _build():
    """Import Triton and define the kernel (once per process). Triton reads
    the names a kernel uses from its module's globals, so ``tl``,
    ``libdevice`` and the helper ``_emit`` are bound there, here."""
    global _KERNEL, tl, libdevice, _emit
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _emit(X, u_row, w_row, out_row, rows, rmask, cols, cmask, IS_PSI: tl.constexpr):
        """Add sum_n w[n] exp(u[n] - X[n, c]) (members) or exp(-X) (psi) of
        this row tile into out[c]. The barrier makes the previous tile's
        store of out visible to every thread of the program."""
        if IS_PSI:
            x = -X
        else:
            u = tl.load(u_row + rows, mask=rmask, other=0.0)
            x = u[:, None] - X
        w = tl.load(w_row + rows, mask=rmask, other=0.0)
        col = tl.sum(libdevice.exp(x) * w[:, None], axis=0)
        tl.debug_barrier()
        tl.store(out_row + cols, tl.load(out_row + cols, mask=cmask, other=0.0) + col,
                 mask=cmask)

    @triton.jit(do_not_specialize=['B', 'P', 'M', 'N', 'NQ', 'NC', 'COL0', 'KU', 'L', 'ROWS',
                                   'K_SINGLE', 'K_ACC'])
    def sweep(A, Q, U, W, UL, WL, OUT, OUTL, B, P, M, N, NQ, NC, COL0, KU, L, ROWS,
              K_SINGLE, K_ACC, IS_PSI: tl.constexpr, REVERSE: tl.constexpr,
              EMIT_SINGLE: tl.constexpr, EMIT_ACC: tl.constexpr, EMIT_LAST: tl.constexpr,
              BN: tl.constexpr, BC: tl.constexpr):
        """A (B, P, M, N), Q (B, P, M, NQ) from column COL0; members: U (B,
        KU, P, M, N), W (B, P, N), UL (B, P, N), WL = W; psi: W (B, KU, M, L,
        N), WL (B, L, N), plane p = l * L + i. OUT (G, B, KU, M, P, NC),
        OUTL (G, B, P, NC). Program (column tile x plane, row group)."""
        n_ct = tl.cdiv(NC, BC)
        pid = tl.program_id(0)
        bp = (pid // n_ct).to(tl.int64)                  # b * P + p
        grp = tl.program_id(1).to(tl.int64)
        b = bp // P
        p = bp % P
        cols = (pid % n_ct) * BC + tl.arange(0, BC)
        cmask = cols < NC
        lo = grp * ROWS
        hi = tl.minimum(lo + ROWS, N)
        a_row = A + bp * M * N
        q_row = Q + bp * M * NQ + COL0
        out_base = OUT + ((grp * B + b) * KU * M * P + p) * NC
        out_last = OUTL + (grp * B * P + bp) * NC
        if IS_PSI:
            l = p // L
            u_base = U
            w_base = W + (b * KU * M * L + l) * N        # + (k M + m) L N
            w_step = L * N
            ul_row = UL
            wl_row = WL + (b * L + l) * N
        else:
            u_base = U + (b * KU * P + p) * M * N        # + (k P M + m) N
            w_base = W + bp * N
            w_step = 0
            ul_row = UL + bp * N
            wl_row = w_base
        for n0 in range(lo, hi, BN):
            rows = n0 + tl.arange(0, BN)
            rmask = rows < hi
            E = tl.zeros((BN, BC), dtype=tl.float64)
            for step in range(M):
                if REVERSE:
                    m = M - 1 - step
                else:
                    m = step
                a = tl.load(a_row + m * N + rows, mask=rmask, other=0.0)
                q = tl.load(q_row + m * NQ + cols, mask=cmask, other=0.0)
                d = a[:, None] - q[None, :]
                e = d * d
                E = E + e
                if EMIT_SINGLE:
                    _emit(e, u_base + (K_SINGLE * P * M + m) * N,
                         w_base + (K_SINGLE * M + m) * w_step,
                         out_base + (K_SINGLE * M + m) * P * NC, rows, rmask, cols, cmask,
                         IS_PSI=IS_PSI)
                if EMIT_ACC:
                    _emit(E, u_base + (K_ACC * P * M + m) * N,
                         w_base + (K_ACC * M + m) * w_step,
                         out_base + (K_ACC * M + m) * P * NC, rows, rmask, cols, cmask,
                         IS_PSI=IS_PSI)
            if EMIT_LAST:
                _emit(E, ul_row, wl_row, out_last, rows, rmask, cols, cmask, IS_PSI=IS_PSI)

    _KERNEL = sweep
    return _KERNEL


def groups(N: int, programs: int) -> Tuple[int, int]:
    """(row groups, rows a group) for a launch of ``programs`` (plane,
    column tile) programs over N rows: enough groups to reach
    TARGET_PROGRAMS, each a whole number of row tiles."""
    tiles = -(-N // BLOCK_ROWS)
    wanted = min(tiles, max(1, -(-TARGET_PROGRAMS // max(programs, 1))))
    rows = -(-tiles // wanted) * BLOCK_ROWS
    return -(-N // rows), rows


def column_bytes(B: int, P: int, KU: int, M: int) -> int:
    """Device bytes of partial sums a column of a chunk costs with one row
    group (the kernel's largest per-column cost)."""
    return 8 * B * P * (KU * M + 1)


def _check(name: str, t: torch.Tensor, device: torch.device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f'W/T sweep kernel: {name} must be on {device}, got {t.device}.')
    if t.dtype != torch.float64:
        raise TypeError(f'W/T sweep kernel: {name} must be float64, got {t.dtype}.')
    if not t.is_contiguous():
        raise ValueError(f'W/T sweep kernel: {name} must be contiguous.')
    if t.numel() > _INT_MAX:
        raise ValueError(f'W/T sweep kernel: {name} {tuple(t.shape)} exceeds 32-bit indexing.')


def sweep(planes: Dict[str, torch.Tensor], col0: int, ncols: int,
          passes: Sequence[Tuple[bool, Optional[int], Optional[int], bool]], psi_L: int = 0
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's column sums of one chunk, columns [col0, col0 + ncols),
    for one kind of plane: members (``psi_L`` 0; ``planes`` A, Q, W and U
    where kinds are swept, UL for a last emission) or psi (``psi_L`` = L;
    A, Q, W, and WL for a last emission), shapes as in the kernel. Each pass
    (reverse, single slot, accumulated slot, last) is one launch over the
    dims, writing its kinds' slots. Returns (out (B, KU, M, P, ncols),
    last (B, P, ncols) or None), summed over the row groups."""
    global LAUNCHES
    A, Q, W = planes['A'], planes['Q'], planes['W']
    B, P, M, N = A.shape
    KU = W.shape[1] if psi_L else (planes['U'].shape[1] if 'U' in planes else 0)
    device = A.device
    for name, t in planes.items():
        _check(name, t, device)
    last = any(p[3] for p in passes)
    programs = -(-ncols // BLOCK_COLS) * B * P
    G, rows = groups(N, programs)
    out = torch.zeros((G, B, KU, M, P, ncols), dtype=A.dtype, device=device)
    out_last = torch.zeros((G, B, P, ncols) if last else (1,), dtype=A.dtype, device=device)
    for t, name in ((out, 'partial sums'), (out_last, 'last partial sums')):
        if t.numel() > _INT_MAX:
            raise ValueError(f'W/T sweep kernel: {name} {tuple(t.shape)} exceed 32-bit indexing.')
    if ncols == 0:
        return out.sum(0), (out_last.sum(0) if last else None)
    kernel = _build()
    # An array a launch does not read (psi's U, an empty kind axis) is
    # handed over as a one-element stand-in.
    U, W, UL, WL, OUT = (t if t is not None and t.numel() else out_last for t in (
        planes.get('U'), W, planes.get('UL'), planes.get('WL', W), out))
    grid = (programs, G)
    for reverse, single, acc, emit_last in passes:
        with torch.cuda.device(device):
            kernel[grid](A, Q, U, W, UL, WL, OUT, out_last,
                         B, P, M, N, Q.shape[-1], ncols, col0, KU, max(psi_L, 1), rows,
                         single or 0, acc or 0,
                         IS_PSI=bool(psi_L), REVERSE=bool(reverse),
                         EMIT_SINGLE=single is not None, EMIT_ACC=acc is not None,
                         EMIT_LAST=bool(emit_last), BN=BLOCK_ROWS, BC=BLOCK_COLS,
                         num_warps=WARPS)
        LAUNCHES += 1
    return out.sum(0), (out_last.sum(0) if last else None)
