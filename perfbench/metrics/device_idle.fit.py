"""The device's idle share over the profiled rounds of a training cell, in
%: 100 (1 - busy / window), busy the union of the intervals in which a
kernel, copy or set ran (torch.profiler), window the segment's host-clock
length, ending in a synchronize."""

UNIT, LAYER, MOVES = '%', 'device', 'eval_ms'


def read(record):
    profile = record.get('profile')
    if not record.get('route') or not profile or profile.get('window_s', 0) <= 0:
        return None
    return 100.0 * (1.0 - profile['busy_s'] / profile['window_s'])
