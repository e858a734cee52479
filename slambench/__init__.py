"""slambench: the benchmark of pslam_tpu_torch on one NVIDIA H100.

``python slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once (see ``harness.py``).
"""
