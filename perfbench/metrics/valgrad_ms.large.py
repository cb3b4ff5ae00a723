"""Mean milliseconds of one value and gradient on the large route
(``DistributedGP.lml`` on its one-card engine), from the objective's call to
its gradient on the host. Read from the benchmark's wrapper of the objective
over the whole window; nothing where the route is not 'large'."""

UNIT, LAYER, MOVES = 'ms', 'large-N route (parallel/distributed.py, parallel/cyclic_deferred.py)', 'eval_ms'


def read(record):
    if record.get('route') != 'large':
        return None
    spans = record['valgrad_s']
    return 1e3 * sum(spans) / len(spans)
