"""Mean device milliseconds of the large route's inverse in one value and
gradient: the program's span 'mesh_lml.inverse' (``MeshLML.forward``,
``engine.residual``: on 'cyclic2' V = U^-1 in place, float64), over the
traced segment's evaluations."""

from perfbench import spans

UNIT, LAYER, MOVES = ('ms', 'large-N route (parallel/distributed.py, parallel/cyclic_deferred.py)',
                      'eval_ms')


def read(record, program_spans=None):
    return spans.mean_device_ms('mesh_lml.inverse', program_spans)
