"""The device's idle share over one profiled Sobol' pass, in %:
100 (1 - busy / window), busy the union of the intervals in which a kernel,
copy or set ran (torch.profiler), window the pass's host-clock length,
ending in a synchronize."""

UNIT, LAYER, MOVES = '%', 'device', 'gsa_pass_s'


def read(record):
    profile = record.get('profile')
    if 'gsa_intervals_s' not in record or not profile or profile.get('window_s', 0) <= 0:
        return None
    return 100.0 * (1.0 - profile['busy_s'] / profile['window_s'])
