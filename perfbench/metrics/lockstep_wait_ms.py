"""Mean milliseconds a round of the lockstep waits until every live descent
has handed in its next point: the program's span 'lbfgs.gather'
(``ops.lbfgs.minimize_lockstep``, the calling thread), host clock, over the
traced segment's rounds. The slowest descent's scipy step and the threads'
turns at the interpreter lock; part of ``host_step_ms``."""

from perfbench import spans

UNIT, LAYER, MOVES = 'ms', 'optimizer (ops/lbfgs.py)', 'eval_ms'


def read(record, program_spans=None):
    found = spans.closed('lbfgs.gather', program_spans)
    return sum(s['host_ms'] for s in found) / len(found) if found else None
