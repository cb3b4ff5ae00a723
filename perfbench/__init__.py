"""The benchmark of romcomma_tpu_torch on an NVIDIA H100: run one cell of
BENCHMARK.json with ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see perfbench/README.md)."""
