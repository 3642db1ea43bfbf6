"""The benchmark of ``foley_tpu_torch`` on one CUDA card: ``python3 port_bench/run.py``."""
