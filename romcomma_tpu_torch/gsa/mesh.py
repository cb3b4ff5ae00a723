"""The factorized GSA sweeps over the ranks of an ('n',) mesh.

Counterpart of ``romcomma_tpu/gsa/mesh.py``. The V pass
(``calibrators._intervals_pass``) and the W/T sweep
(``factorized_errors.error_scan_folds``) are sums over chunks of the q
columns: every chunk's quadforms add into small accumulators, and its psi
factors are its own columns. So each rank runs a contiguous share of the
chunks, the accumulators are summed by one all_reduce, and the psi columns
come back whole, in the original column order, on every rank (each rank
fills its own columns of a zero array, and one all_reduce adds them). The
arithmetic of each chunk is the one-device loop's; only the order of the
additions across chunks changes.

A calibrator takes this route when ``DistributedGP.sobol_indices`` sets its
``gsa_mesh`` attribute, as romcomma_tpu's does. Every rank of the mesh must
run the same sweep.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from romcomma_tpu_torch.parallel.distributed import Ring


def my_starts(ring: Ring, starts: Sequence[int]) -> List[int]:
    """This rank's contiguous share of the chunk starts (romcomma_tpu pads
    the chunk axis to a multiple of S and shards it evenly)."""
    share = -(-len(starts) // ring.S)
    return list(starts[ring.me * share:(ring.me + 1) * share])


def intervals_sweep(mesh, starts: Sequence[int], step: Callable, acc: Tuple) -> Tuple:
    """The V pass's chunk loop over the mesh: ``step(acc, start)`` adds
    the chunk at ``start`` to the accumulators ``acc``; returns them summed
    over every chunk of every rank, the same on every rank."""
    ring = Ring(mesh)
    for start in my_starts(ring, starts):
        acc = step(acc, start)
    return tuple(ring.psum(a.clone()) for a in acc)     # acc's entries may share storage


def error_sweep(mesh, N: int, chunk: int, step: Callable, kinds: Sequence[str]
                ) -> Tuple[Dict[str, tuple], Dict[str, torch.Tensor]]:
    """The W/T sweep's chunk loop over the mesh: ``step(q)`` runs the chunk
    of columns ``q`` (a slice) and returns {kind: (member quads, psi
    (..., columns))}. Returns (quads {kind: tuple}, psi {kind: (..., N)}),
    the quads summed over every chunk, the psi columns in their original
    order; both the same on every rank. A rank without a chunk runs an empty
    one, which gives its zero quads."""
    ring = Ring(mesh)
    mine = my_starts(ring, range(0, N, chunk))
    q = [slice(start, min(start + chunk, N)) for start in mine] or [slice(N, N)]
    quads, psi_parts = None, {k: [] for k in kinds}
    for columns in q:
        out = step(columns)
        quads = ({k: out[k][0] for k in kinds} if quads is None else
                 {k: tuple(q0 + q1 for q0, q1 in zip(quads[k], out[k][0])) for k in kinds})
        for k in kinds:
            psi_parts[k].append(out[k][1])
    quads = {k: tuple(ring.psum(x.clone()) for x in quads[k]) for k in kinds}
    psi = {}
    for k in kinds:
        part = torch.cat(psi_parts[k], dim=-1)
        whole = torch.zeros(part.shape[:-1] + (N,), dtype=part.dtype, device=part.device)
        whole[..., q[0].start:q[0].start + part.shape[-1]] = part
        psi[k] = ring.psum(whole)
    return quads, psi
