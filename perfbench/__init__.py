"""The benchmark of ``repro_torch``: ``python3 perfbench/run.py --workload <cell> ...``."""
