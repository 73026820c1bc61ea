"""The benchmark of cvd_tpu_torch on an NVIDIA H100: ``python3
port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
