"""Per-layer metric readers, one file per metric of BENCHMARK.json's
``per_layer``, named as the metric is (perfbench/metrics/<name>.py)."""
