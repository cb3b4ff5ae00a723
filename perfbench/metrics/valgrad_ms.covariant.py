"""Mean milliseconds of one value and gradient of the covariant MOGP
(``models.gp.CovariantUpperLML`` over its (L N, L N) system), from the
objective's call to its gradient on the host. Read from the benchmark's
wrapper of the objective over the whole window; nothing where the route is
not 'covariant'."""

UNIT, LAYER, MOVES = 'ms', 'covariant LML (models/gp.py)', 'eval_ms'


def read(record):
    if record.get('route') != 'covariant':
        return None
    spans = record['valgrad_s']
    return 1e3 * sum(spans) / len(spans)
