"""Mean milliseconds of one round's value and gradient on the small route:
one batched ExactLML of every live descent of a fold group
(``models.gp.calibrate_variant_folds``), from the objective's call to its
gradient on the host. Read from the benchmark's wrapper of the objective
over the whole window; nothing where the route is not 'folds'."""

UNIT, LAYER, MOVES = 'ms', 'small-route LML (models/gp.py)', 'eval_ms'


def read(record):
    if record.get('route') != 'folds':
        return None
    spans = record['valgrad_s']
    return 1e3 * sum(spans) / len(spans)
