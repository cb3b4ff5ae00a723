"""Mean device milliseconds of the covariant LML's inverse stage in one value
and gradient: the program's span 'covariant_lml.inverse' (``models/gp.py``,
``CovariantUpperLML``: K^-1 from the factor (cholesky_inverse) and the alpha
alpha^T update), over the traced segment's evaluations."""

from perfbench import spans

UNIT, LAYER, MOVES = 'ms', 'covariant LML (models/gp.py)', 'eval_ms'


def read(record, program_spans=None):
    return spans.mean_device_ms('covariant_lml.inverse', program_spans)
