"""The whole training step's share of the card's peak, in %: the model
FLOPs of every live descent's value and gradient in the window's rounds
(perfbench/flops.py: N^3/3 for the factor, 2 N^3/3 for K^-1, 2 N^2 M each
for the gram's cross term and the lengthscale gradient, whatever the engine
does) over the window's host-clock length and 67 TFLOP/s, the float32 peak
and the FP64 tensor-core peak alike."""

from perfbench import flops

UNIT, LAYER, MOVES = '%', 'whole step', 'eval_ms'


def read(record):
    if not record.get('model_flops'):
        return None
    return flops.mfu_percent(record['model_flops'], record['window_s'])
