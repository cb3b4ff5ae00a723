"""The unit-gram kernel's share of its roofline, in %: over the launches of
the profiled rounds, the sum of each launch's least time (the larger of
2 A B M float32 multiply-adds at 67 TFLOP/s and its inputs read once and E
written once at 3.35 TB/s, perfbench/flops.py) over the device time the
trace gives the kernel's two CUDA functions (the pack pre-pass and the tile
kernel). The shapes come from the benchmark's wrapper of
``ops.gram_kernels.unit_gram_cuda``. Nothing where no launch was traced."""

from perfbench import flops

UNIT, LAYER, MOVES = '%', 'kernel (ops/gram_kernels.py, csrc/unit_gram.cu)', 'eval_ms'
KERNELS = ('pack_kernel', 'unit_gram_kernel')


def read(record):
    profile = record.get('profile') or {}
    launches = profile.get('launches') or []
    device_s = sum(seconds for name, seconds in profile.get('kernel_s', {}).items()
                   if any(kernel in name for kernel in KERNELS))
    if not launches or device_s <= 0:
        return None
    least = sum(flops.unit_gram_least_seconds(*shape) for shape in launches)
    return 100.0 * least / device_s
