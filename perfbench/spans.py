"""The program's own spans (``romcomma_tpu_torch.base.tracing``) for the
per-layer readers. The tracer records while a torch.profiler records, and
nothing in a run turns one on but the traced segment, so its spans are the
segment's. A reader takes the spans of one name that closed without an
error; a program without the tracer has none, and the reader reads
nothing."""

from typing import Any, Dict, List, Optional


def closed(name: str, spans: Optional[List[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
    """The spans named ``name`` that closed without an error, of ``spans`` or
    else of the program's tracer."""
    if spans is None:
        try:
            from romcomma_tpu_torch.base import tracing
        except ImportError:
            return []
        spans = tracing.spans()
    return [s for s in spans if s['name'] == name and not s['error']]


def device_ms(found: List[Dict[str, Any]]) -> Optional[List[float]]:
    """Each span's device milliseconds; None where there is no span, or one
    has no device time (a span on the CPU)."""
    ms = [s['device_ms'] for s in found]
    return ms if ms and all(m is not None for m in ms) else None


def mean_device_ms(name: str, spans: Optional[List[Dict[str, Any]]] = None) -> Optional[float]:
    """The mean device milliseconds of the spans named ``name``."""
    ms = device_ms(closed(name, spans))
    return sum(ms) / len(ms) if ms else None


def device_ms_per_member(name: str,
                         spans: Optional[List[Dict[str, Any]]] = None) -> Optional[float]:
    """The device milliseconds of the spans named ``name`` over their
    ``members``, both summed: milliseconds per member."""
    found = closed(name, spans)
    ms = device_ms(found)
    return sum(ms) / sum(s['attrs']['members'] for s in found) if ms else None
