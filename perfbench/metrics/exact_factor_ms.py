"""Device milliseconds of the batched ExactLML's forward per descent
evaluation: the program's span 'exact_lml.factor' (``models/gp.py``, each
member's Cholesky and two solves, member by member) over its ``members``,
both summed over the traced segment's rounds."""

from perfbench import spans

UNIT, LAYER, MOVES = 'ms', 'small-route LML (models/gp.py)', 'eval_ms'


def read(record, program_spans=None):
    return spans.device_ms_per_member('exact_lml.factor', program_spans)
