"""The port's benchmark: ``python3 bench/run.py --workload <cell> ...``."""
