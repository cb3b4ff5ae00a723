"""Mean device milliseconds of the large route's factor in one value and
gradient: the program's span 'mesh_lml.factor' (``MeshLML.forward``,
``engine.chol``: on 'cyclic2' the float64 deferred Cholesky in place), over
the traced segment's evaluations."""

from perfbench import spans

UNIT, LAYER, MOVES = ('ms', 'large-N route (parallel/distributed.py, parallel/cyclic_deferred.py)',
                      'eval_ms')


def read(record, program_spans=None):
    return spans.mean_device_ms('mesh_lml.factor', program_spans)
