"""Mean device seconds of the Sobol' pass's W/T error sweep: the program's
span 'gsa.wt_sweep' (``gsa/calibrators.py`` around
``factorized_errors.intervals_folds``: the error planes chunk by chunk, the
determinants and the psi solve), over the traced segment's pass."""

from perfbench import spans

UNIT, LAYER, MOVES = 's', 'GSA (gsa/calibrators.py, gsa/factorized_errors.py)', 'gsa_pass_s'


def read(record, program_spans=None):
    ms = spans.mean_device_ms('gsa.wt_sweep', program_spans)
    return None if ms is None else ms / 1e3
