"""Spans of the port's own layers, kept in memory.

    with tracing.span('exact_lml.factor', on=x.device, members=B):
        ...

A span records its name, its attributes (a count that belongs to the span is
one of them, ``members=B``: there are no counters here; the kernels' launch
counts are ``ops.gram_kernels.LAUNCHES`` and ``gsa.sweep_kernel.LAUNCHES``),
the span open around it in the same thread (``parent``, by ``id``), its thread, its host
start and end (``time.perf_counter_ns``, and ``host_ms``), and ``error``,
whether it exited by an exception. On a CUDA device (``on``) it also records
a pair of timing events on the current stream, at entry and at exit; their
interval, ``device_ms``, is resolved when ``spans()`` is read, with one
synchronize there and never on the hot path (None elsewhere). While a
``torch.profiler`` records, a span also opens
``torch.profiler.record_function(name)`` over the same interval, which puts
the program's spans on the profiler's clock beside the device's kernels.

``mode``: 'auto' (the default) records exactly while a torch.profiler
records, as in the benchmark's traced segment or under
``user.contexts.Environment(profile_dir=...)``, whose trace is the operator's
export of them; 'on' records always; 'off' never. Where nothing records,
``span`` returns one shared no-op context: it allocates nothing and reads no
clock. Spans stay in memory until ``reset()``; nothing is written."""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

MODES = ('auto', 'on', 'off')

_mode = 'auto'
_lock = threading.Lock()
#: Closed spans, in the order they closed.
_closed: List[Dict[str, Any]] = []
#: (record, device, start event, end event) of closed spans not yet resolved.
_unresolved: List[tuple] = []
_ids = itertools.count()
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc_info):
        return False


_NO_SPAN = _NoSpan()


def mode(m: str) -> str:
    """Set the mode ('auto', 'on' or 'off'); returns the one it replaces."""
    global _mode
    if m not in MODES:
        raise ValueError(f'tracing mode {m!r}: one of {MODES}.')
    previous, _mode = _mode, m
    return previous


def span(name: str, on: Optional[torch.device] = None, **attrs: Any):
    """A context manager that records the body as one span named ``name``
    with ``attrs``; on the device ``on`` (a CUDA device) with its device
    time too. Entered, it gives the span's record, or None where nothing
    records."""
    if _mode == 'off' or (_mode == 'auto' and not _profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, on, attrs)


def spans() -> List[Dict[str, Any]]:
    """The spans closed since the last ``reset()``, in the order they closed,
    each a dict: name, attrs, id, parent, thread, start_ns, end_ns, host_ms,
    device_ms and error."""
    with _lock:
        if _unresolved:
            for device in {device for _, device, _, _ in _unresolved}:
                torch.cuda.synchronize(device)
            for record, _, start, end in _unresolved:
                record['device_ms'] = start.elapsed_time(end)
            _unresolved.clear()
        return list(_closed)


def reset():
    """Forget every closed span."""
    with _lock:
        _closed.clear()
        _unresolved.clear()


def _stack() -> List[Dict[str, Any]]:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ('record', 'device', 'stream', 'events', 'annotation')

    def __init__(self, name: str, on: Optional[torch.device], attrs: Dict[str, Any]):
        self.record = {'name': name, 'attrs': attrs}
        self.device = on if on is not None and on.type == 'cuda' else None
        self.events = self.annotation = None

    def __enter__(self) -> Dict[str, Any]:
        stack, record = _stack(), self.record
        record.update(id=next(_ids), parent=stack[-1]['id'] if stack else None,
                      thread=threading.get_ident())
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(record['name'])
            self.annotation.__enter__()
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        stack.append(record)
        record['start_ns'] = time.perf_counter_ns()
        return record

    def __exit__(self, kind, value, traceback) -> bool:
        end = time.perf_counter_ns()
        record = self.record
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.annotation is not None:
            self.annotation.__exit__(kind, value, traceback)
        _stack().pop()
        record.update(end_ns=end, host_ms=(end - record['start_ns']) / 1e6, device_ms=None,
                      error=kind is not None)
        with _lock:
            _closed.append(record)
            if self.events is not None:
                _unresolved.append((record, self.device, *self.events))
        return False
