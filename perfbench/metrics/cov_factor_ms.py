"""Mean device milliseconds of the covariant LML's factor stage in one value
and gradient: the program's span 'covariant_lml.factor' (``models/gp.py``,
``CovariantUpperLML``: the Cholesky factor of the assembled (L N, L N)
system), over the traced segment's evaluations."""

from perfbench import spans

UNIT, LAYER, MOVES = 'ms', 'covariant LML (models/gp.py)', 'eval_ms'


def read(record, program_spans=None):
    return spans.mean_device_ms('covariant_lml.factor', program_spans)
