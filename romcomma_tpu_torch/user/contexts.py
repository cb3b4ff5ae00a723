"""Context managers: Timer and Environment (reference: romcomma/user/contexts.py).
Counterpart of ``romcomma_tpu/user/contexts.py``, with a torch device in place
of the JAX platform."""

from __future__ import annotations

from contextlib import contextmanager
from datetime import timedelta
from time import time
from typing import Optional

import torch


@contextmanager
def Timer(name: str = '', is_inline: bool = True):
    """Print-based wall-clock timing context (reference contexts.py:32-52)."""
    _enter = time()
    if name != '':
        if is_inline:
            print(f'Running {name}', end='', flush=True)
        else:
            print(f'Running {name}...', flush=True)
    yield
    if name != '':
        _exit = time()
        if is_inline:
            print(f' took {timedelta(seconds=int(_exit - _enter))}.')
        else:
            print(f'...took {timedelta(seconds=int(_exit - _enter))}.')


@contextmanager
def Environment(name: str = '', device: str = '', profile_dir: Optional[str] = None, **kwargs):
    """Runtime environment context.

    Args:
        name: Printed label.
        device: 'CPU' / 'GPU' / '' (automatic). The port computes on the device
            that base.definitions.device() resolves (CUDA when present); a
            request it cannot honour raises.
        profile_dir: If given, a torch.profiler trace is written there.
    """
    from romcomma_tpu_torch.base.definitions import FLOAT, device as compute_device
    with Timer(name):
        resolved = compute_device()
        d = device.upper()
        wanted = 'cpu' if 'CPU' in d else 'cuda' if 'GPU' in d else resolved.type
        if wanted != resolved.type:
            raise RuntimeError(f'Environment asked for {device!r}, but the compute device '
                               f'is {resolved}.')
        print(f' using torch({resolved}, working dtype={FLOAT().name})...', flush=True)
        if profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if resolved.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(
                    activities=activities,
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir)):
                yield
        else:
            yield
        print('...Running ' + name, end='')
