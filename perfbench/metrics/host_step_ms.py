"""Mean milliseconds per round of the optimizer outside the evaluation: from
the moment a round's gradient reached the host to the start of the next
round (scipy's L-BFGS-B steps, the lockstep's hand-over between descents,
and the set-up of the next call where one ends). Read from the benchmark's
wrapper of the objective over the whole window."""

UNIT, LAYER, MOVES = 'ms', 'optimizer (ops/lbfgs.py)', 'eval_ms'


def read(record):
    host = record.get('host_s')
    return 1e3 * sum(host) / len(host) if host else None
