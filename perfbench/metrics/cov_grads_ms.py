"""Mean device milliseconds of the covariant LML's grads stage in one value and
gradient: the program's span 'covariant_lml.grads' (``models/gp.py``,
``CovariantUpperLML``: the (L, L) block sums of W o unit and of W's block
diagonals), over the traced segment's evaluations."""

from perfbench import spans

UNIT, LAYER, MOVES = 'ms', 'covariant LML (models/gp.py)', 'eval_ms'


def read(record, program_spans=None):
    return spans.mean_device_ms('covariant_lml.grads', program_spans)
