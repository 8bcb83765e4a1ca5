"""The benchmark of ``mvslam_tpu_torch`` on an NVIDIA H100: one command
(``python3 slambench/run.py --workload NAME --seed N --seconds S --trace
0|1``) runs one cell of ``BENCHMARK.json`` once."""
