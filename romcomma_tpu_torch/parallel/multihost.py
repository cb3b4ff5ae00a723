"""Folds and sweep cells shared out over processes.

Counterpart of ``romcomma_tpu/parallel/multihost.py``. Every stage of a run
persists to its own folder of CSV + meta.json, so folds (and sweep cells)
can be partitioned across processes deterministically: each process trains
only its share on its own device, and the tree on a shared filesystem is the
medium; aggregation (``collect_gpr``/``collect_gsa``) runs once every share
is on disk.

Two deployment styles, one code path:
  - **torch.distributed** (``torchrun``): call :func:`init` first; the
    process's identity is its rank and the group's size.
  - **launcher-driven** (a SLURM array, parallel SSH, a shared filesystem):
    set ``ROMCOMMA_PROCESS_ID`` / ``ROMCOMMA_NUM_PROCESSES`` per task; no
    connection between the processes at all.

A process that trains its share (:func:`gpr`, :func:`gsa`) works alone
(``base.definitions.solo()``): ``parallel.distributed.make_n_mesh()`` gives
its own device, it writes what it trains, and it enters no collective.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path
from typing import Any, List, Optional, Sequence

from romcomma_tpu_torch.base.definitions import in_process_group, solo, write_once
from romcomma_tpu_torch.data.storage import Fold, Repository

#: How long a collective waits for the other ranks before it fails.
TIMEOUT = datetime.timedelta(seconds=600)


def init(init_method: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None,
         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Initialize the default process group: from torchrun's environment
    (``init_method`` None: env://), or from an ``init_method`` URL with the
    given size and rank. A no-op under the launcher-driven variables or
    where the group exists. NCCL where CUDA is available, each rank on
    cuda:LOCAL_RANK; gloo otherwise."""
    import torch
    import torch.distributed as dist
    if 'ROMCOMMA_NUM_PROCESSES' in os.environ or dist.is_initialized():
        return
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', process_id or 0)))
    kwargs = {} if init_method is None else dict(init_method=init_method,
                                                 world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, timeout=timeout, **kwargs)


def process_identity() -> tuple:
    """(process_id, num_processes): the launcher variables win, then the
    process group's rank and size, then (0, 1)."""
    if 'ROMCOMMA_NUM_PROCESSES' in os.environ:
        return (int(os.environ.get('ROMCOMMA_PROCESS_ID', '0')),
                int(os.environ['ROMCOMMA_NUM_PROCESSES']))
    if in_process_group():
        import torch.distributed as dist
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_share(items: Sequence[Any], process_id: Optional[int] = None,
             num_processes: Optional[int] = None) -> List[Any]:
    """Deterministic round-robin partition of ``items`` for this process.
    Round-robin (not block) so heterogeneous cost along the sequence (the
    improper fold, a sweep's growing N) spreads across processes."""
    pid, nproc = process_identity()
    pid = pid if process_id is None else process_id
    nproc = nproc if num_processes is None else num_processes
    return [item for i, item in enumerate(items) if i % nproc == pid]


def my_folds(repo: Repository, **kwargs) -> List[int]:
    """The fold indices this process owns."""
    return my_share(list(repo.folds), **kwargs)


def gpr(name: str, repo: Repository, is_read: Optional[bool],
        is_covariant: Optional[bool], is_isotropic: Optional[bool],
        ignore_exceptions: bool = False, **kwargs) -> List[str]:
    """user.run.gpr over ONLY this process's folds (no aggregation), each on
    this process's own device. Run :func:`collect_gpr` once afterwards:
    behind a :func:`barrier`, or as a separate collect-only job."""
    from romcomma_tpu_torch.user import run
    folds = my_folds(repo)
    names: List[str] = []
    with solo():
        for k in folds:
            names = run.gpr(name, Fold(repo, k), is_read, is_covariant, is_isotropic,
                            ignore_exceptions, **kwargs)
    return names


def gsa(name: str, repo: Repository, is_covariant: Optional[bool],
        is_isotropic: Optional[bool], ignore_exceptions: bool = False,
        is_error_calculated: bool = False, **kwargs) -> List[Path]:
    """user.run.gsa over ONLY this process's folds (no aggregation), each on
    this process's own device."""
    from romcomma_tpu_torch.user import run
    folds = my_folds(repo)
    names: List[Path] = []
    with solo():
        for k in folds:
            names = run.gsa(name, Fold(repo, k), is_covariant, is_isotropic,
                            ignore_exceptions=ignore_exceptions,
                            is_error_calculated=is_error_calculated, **kwargs)
    return names


def missing_shares(names: Sequence[Any], repo: Repository) -> List[Path]:
    """Per-fold result folders that are NOT yet on disk: the completeness
    check before aggregation in launcher-driven mode, where :func:`barrier`
    cannot sequence processes."""
    return [repo.fold_folder(k) / str(n)
            for k in repo.folds for n in names
            if not (repo.fold_folder(k) / str(n)).exists()]


def _check_shares(names: Sequence[Any], repo: Repository, ignore_exceptions: bool) -> None:
    missing = missing_shares(names, repo)
    if missing and not ignore_exceptions:
        raise FileNotFoundError(
            'collect called before every fold share is on disk: missing '
            + ', '.join(str(p) for p in missing[:8]) + (' ...' if len(missing) > 8 else ''))


def collect_gpr(names: Sequence[str], repo: Repository, ignore_exceptions: bool = True) -> None:
    """Aggregate per-fold GPR results across ALL folds, once every share is
    on disk: user.run.gpr's Collects. Under a process group rank 0 writes."""
    from romcomma_tpu_torch.user import results
    _check_shares(names, repo, ignore_exceptions)
    results.Collect({'test': {'header': [0, 1]},
                     'test_summary': {'header': [0, 1], 'index_col': 0}},
                    {n: {} for n in names}, ignore_exceptions).from_folds(repo, True)
    results.Collect({'variance': {}, 'log_marginal': {}},
                    {f'{n}/likelihood': {} for n in names},
                    ignore_exceptions).from_folds(repo, True)
    results.Collect({'variance': {}, 'lengthscales': {}},
                    {f'{n}/kernel': {} for n in names},
                    ignore_exceptions).from_folds(repo, True)


def collect_gsa(names: Sequence[Path], repo: Repository, is_error_calculated: bool = False,
                ignore_exceptions: bool = True) -> None:
    """Aggregate per-fold GSA results, once every share is on disk."""
    import shutil
    from romcomma_tpu_torch.user import results
    _check_shares(names, repo, ignore_exceptions)
    results.Collect({'S': {}, 'V': {}} | ({'T': {}, 'W': {}} if is_error_calculated else {}),
                    {str(n): {} for n in names}, ignore_exceptions).from_folds(repo, True)
    for n in names:
        write_once(shutil.copyfile, repo.fold_folder(repo.folds.start) / 'meta.json',
                   repo.folder / n / 'meta.json')


def barrier() -> None:
    """Block until every rank of the process group reaches this point. In
    launcher-driven mode there is no connection: the caller sequences the
    collect step outside (a dependent SLURM job), so this is a no-op."""
    if 'ROMCOMMA_NUM_PROCESSES' in os.environ or not in_process_group():
        return
    import torch.distributed as dist
    dist.barrier()
