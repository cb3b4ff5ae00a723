"""Global dtype registry, reference floors and the compute device.

Counterpart of ``romcomma_tpu/base/definitions.py``. ``ROMCOMMA_X64`` is read
once, at import: ``1`` (the default) makes float64 the working dtype
everywhere (the verification mode); ``0`` selects the float32 fast path, in
which every float32 gram on a CUDA device goes through the hand-written
unit-gram kernel. The posterior factorization is float64 in both modes.

Float32 matrix products run in true float32: TF32 keeps about three decimal
digits, which the gram, every linear solve and every variance cancellation
downstream cannot afford (the counterpart of the JAX package's
``jax_default_matmul_precision='highest'``).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

#: Quantities smaller than this are considered zero (reference: base/definitions.py:36).
EFFECTIVELY_ZERO = 1.0e-64

#: Lower bound on the diagonal of a trainable covariance Cholesky (reference: gpf/base.py:35).
CHOLESKY_DIAGONAL_LOWER_BOUND = 1e-3

#: Floor on likelihood noise variance (reference: gpr/models.py:62-65).
LIKELIHOOD_VARIANCE_FLOOR = 1.0001e-6

#: Floor on kernel signal variance (reference: gpr/kernels.py:176).
KERNEL_VARIANCE_FLOOR = 1.0005e-6

_F32_MODE = os.environ.get('ROMCOMMA_X64', '1') == '0'


def FLOAT() -> np.dtype:
    """The default float dtype: float64 (verification) unless ROMCOMMA_X64=0
    selected the float32 fast path."""
    return np.dtype(np.float32) if _F32_MODE else np.dtype(np.float64)


def INT() -> np.dtype:
    """The default int dtype."""
    return np.dtype(np.int32) if _F32_MODE else np.dtype(np.int64)


def TORCH_FLOAT() -> torch.dtype:
    """FLOAT() as a torch dtype."""
    return torch.float32 if _F32_MODE else torch.float64


_PINNED: Optional[torch.device] = None


#: What device() says where there is no CUDA device and none was pinned.
NO_CUDA_DEVICE = ('romcomma_tpu_torch computes on a CUDA device, and there is none. Ask for the '
                  "CPU explicitly: user.contexts.Environment(device='CPU'), or "
                  "base.definitions.pinned_device(torch.device('cpu')).")


def device() -> torch.device:
    """The compute device: the one pinned by ``pinned_device`` (as
    ``user.contexts.Environment`` does), else the current CUDA device. Where
    there is no CUDA device and nothing was pinned it raises RuntimeError: the
    port never moves to the CPU unless asked to."""
    if _PINNED is not None:
        return _PINNED
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA_DEVICE)
    return torch.device('cuda')


@contextmanager
def pinned_device(pinned: Optional[torch.device]):
    """Make ``device()`` return `pinned` for the body (None: the CUDA device,
    as if nothing were pinned), then restore the previous choice."""
    global _PINNED
    previous, _PINNED = _PINNED, pinned
    try:
        yield
    finally:
        _PINNED = previous


# --------------------------------------------------------------------------- #
# Several ranks (torch.distributed): who writes the model tree
# --------------------------------------------------------------------------- #

_SOLO = False


def in_process_group() -> bool:
    """Whether this process works with others: a default process group is
    initialized and the caller is not inside ``solo()``."""
    import torch.distributed as dist
    return not _SOLO and dist.is_available() and dist.is_initialized()


def group_size() -> int:
    """The number of ranks this process works with: the default process
    group's size, or 1 where there is none or inside ``solo()``."""
    import torch.distributed as dist
    return dist.get_world_size() if in_process_group() else 1


class PeerFailed(RuntimeError):
    """Another rank of the process group failed: raised on every rank at the
    collective where a failing rank announced it (``any_rank_failed``)."""


def _max_over_ranks(flag: float) -> float:
    """The largest of every rank's ``flag``: one MAX all_reduce of one value
    over the default group (on the card under NCCL)."""
    import torch.distributed as dist
    on = torch.device('cuda') if dist.get_backend() == 'nccl' else torch.device('cpu')
    t = torch.tensor([flag], dtype=torch.float32, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def any_rank_failed(failed: bool) -> bool:
    """Whether this rank or any other of the process group failed: under a
    group of several ranks one MAX all_reduce of the flag, the collective
    every rank makes once after an attempt that may fail on some ranks
    alone. It also pairs with the barrier of a ``write_once`` that a rank
    still in the attempt has reached: that rank raises ``PeerFailed`` there,
    and has then agreed. Without a group (or inside ``solo()``) it returns
    ``failed``."""
    if group_size() == 1:
        return failed
    return _max_over_ranks(float(failed)) > 0.0


def _barrier() -> None:
    """write_once's barrier: one MAX all_reduce of 0, which raises
    ``PeerFailed`` where a failing rank announced itself in it."""
    if _max_over_ranks(0.0) > 0.0:
        raise PeerFailed('another rank of the process group failed')


def write_once(write: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
    """Write to the model tree once for the process group: ``write(*args,
    **kwargs)`` on rank 0 alone. Under a group of several ranks a barrier
    before it, so that no rank still reads a file that rank 0 rewrites (a
    model read back, ``MOGP(is_read=True)``, rewrites the CSVs it has just
    read), and one after it, so that no rank reads the tree before the write
    is on disk. Without a process group (or inside ``solo()``) it is a plain
    call. Every rank of a group runs the same folds, so each reaches the
    same write sites in the same order."""
    import torch.distributed as dist
    if group_size() == 1:
        write(*args, **kwargs)
        return
    _barrier()
    if dist.get_rank() == 0:
        write(*args, **kwargs)
    _barrier()


@contextmanager
def solo():
    """The body's work is this process's alone (``parallel.multihost``'s
    share of the folds): ``parallel.distributed.make_n_mesh()`` gives its own
    device, it writes what it trains, and it enters no collective."""
    global _SOLO
    previous, _SOLO = _SOLO, True
    try:
        yield
    finally:
        _SOLO = previous
