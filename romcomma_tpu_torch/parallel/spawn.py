"""Run one function on S ranks of a fresh process group, from one process.

Each rank is a process of its own (the ``spawn`` start method: forking a
process that has started CUDA or torch's threads is unsafe), joins a group
initialized from a file in a temporary folder, computes on its own device
(the CPU with gloo, pinned; cuda:rank with NCCL) with one torch thread, and
sends back what ``fn`` returns. A rank's exception comes back to the caller
with its traceback, and every rank is stopped; so is a run that outlasts
``timeout``, and a collective gives up after at most COLLECTIVE_TIMEOUT. So
a rank that fails never leaves the others waiting.

    results = spawn.run(fn, S, *args)     # [fn(0, *args), ..., fn(S-1, *args)]

``fn`` must be importable by name (a module-level function of a module that
the ranks can import), and its arguments and results picklable.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_module
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional


#: The longest a rank's collective waits for the others, in seconds.
COLLECTIVE_TIMEOUT = 120.0
#: The environment of the ranks' thread pools: one thread each.
_ONE_THREAD = {'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1', 'OPENBLAS_NUM_THREADS': '1'}
_STARTING = threading.Lock()


def _rank_main(fn: Callable, rank: int, S: int, backend: str, init_method: str,
               timeout: float, results, args: tuple) -> None:
    try:
        import torch
        import torch.distributed as dist
        from romcomma_tpu_torch.base.definitions import pinned_device
        torch.set_num_threads(1)
        if backend == 'nccl':
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=S,
                                timeout=datetime.timedelta(seconds=min(timeout, COLLECTIVE_TIMEOUT)))
        try:
            with pinned_device(torch.device('cpu') if backend == 'gloo' else None):
                out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _more_failures(results, S: int, grace: float = 5.0) -> str:
    """The tracebacks of the other ranks that fail within ``grace`` seconds of
    the first: a rank's failure often makes its partners' collectives fail
    too, and the first report need not be the cause."""
    found, deadline = [], time.monotonic() + grace
    while len(found) < S - 1:
        try:
            rank, ok, payload = results.get(timeout=max(0.05, deadline - time.monotonic()))
        except queue_module.Empty:
            break
        if not ok:
            found.append(f'\nrank {rank} of {S} failed too:\n{payload}')
    return ''.join(found)


def run(fn: Callable, S: int, *args: Any, backend: Optional[str] = None,
        timeout: float = 120.0) -> List[Any]:
    """[fn(rank, *args) for each rank] of a fresh group of S ranks: gloo on
    the CPU by default, or ``backend='nccl'`` on S cards. Raises
    RuntimeError with the traceback of the first rank that fails, and
    TimeoutError when the ranks have not all answered within ``timeout``
    seconds; every rank has ended when it returns or raises."""
    import torch.multiprocessing as mp
    backend = backend or 'gloo'
    context = mp.get_context('spawn')
    results = context.Queue()
    with tempfile.TemporaryDirectory() as folder:
        init = f'file://{os.path.join(folder, "group")}'
        processes = [context.Process(target=_rank_main, daemon=True,
                                     args=(fn, rank, S, backend, init, timeout, results, args))
                     for rank in range(S)]
        with _STARTING:                         # os.environ is the process's own
            threads = {name: os.environ.get(name) for name in _ONE_THREAD}
            os.environ.update(_ONE_THREAD)      # read by each rank before torch loads
            try:
                for process in processes:
                    process.start()
            finally:
                for name, value in threads.items():
                    if value is None:
                        os.environ.pop(name)
                    else:
                        os.environ[name] = value
        answers, deadline = {}, time.monotonic() + timeout
        try:
            while len(answers) < S:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_module.Empty:
                    dead = [r for r, process in enumerate(processes)
                            if r not in answers and process.exitcode is not None]
                    if dead:
                        raise RuntimeError(f'ranks {dead} of {S} ended without an answer '
                                           f'(exit codes {[processes[r].exitcode for r in dead]})'
                                           ) from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f'{S - len(answers)} of {S} ranks did not answer '
                                           f'within {timeout} s') from None
                    continue
                if not ok:
                    raise RuntimeError(f'rank {rank} of {S} failed:\n{payload}'
                                       + _more_failures(results, S))
                answers[rank] = payload
        finally:
            for process in processes:
                process.join(timeout=max(1.0, deadline - time.monotonic()) if len(answers) == S
                             else 1.0)
                if process.is_alive():
                    process.kill()
                    process.join()
    return [answers[rank] for rank in range(S)]
