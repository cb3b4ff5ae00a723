"""Mean device seconds of the Sobol' pass's factorized V pass: the
program's span 'gsa.v_pass' (``gsa/calibrators.py``, ``_intervals_pass``:
its planes, chunk by chunk, and the V of every slice), over the traced
segment's pass."""

from perfbench import spans

UNIT, LAYER, MOVES = 's', 'GSA (gsa/calibrators.py, gsa/factorized_errors.py)', 'gsa_pass_s'


def read(record, program_spans=None):
    ms = spans.mean_device_ms('gsa.v_pass', program_spans)
    return None if ms is None else ms / 1e3
