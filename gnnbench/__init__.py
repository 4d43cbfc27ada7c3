"""gnnbench: the benchmark of pagraph_tpu_torch (see run.py)."""
