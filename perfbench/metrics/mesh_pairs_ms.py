"""Mean device milliseconds of the large route's backward in one value and
gradient: the program's span 'mesh_lml.pairs' (``MeshLML.backward``, the
engine's ``grads``: on 'cyclic2' the sweep of pair tiles), over the traced
segment's evaluations."""

from perfbench import spans

UNIT, LAYER, MOVES = ('ms', 'large-N route (parallel/distributed.py, parallel/cyclic_deferred.py)',
                      'eval_ms')


def read(record, program_spans=None):
    return spans.mean_device_ms('mesh_lml.pairs', program_spans)
