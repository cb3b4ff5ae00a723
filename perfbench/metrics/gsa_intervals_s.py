"""Mean seconds of the interval passes of one Sobol' pass with errors: the
program's own ``last_gsa_timings['intervals_s']`` (the V pass and the W/T
sweep over every slice, ending in a copy to the host), read after each pass
of the window."""

UNIT, LAYER, MOVES = 's', 'GSA (gsa/calibrators.py, gsa/factorized_errors.py)', 'gsa_pass_s'


def read(record):
    spans = [s for s in record.get('gsa_intervals_s', []) if s is not None]
    return sum(spans) / len(spans) if spans else None
