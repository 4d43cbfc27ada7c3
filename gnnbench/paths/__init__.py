"""The program's paths a cell can run, one file a path, found by the
workload's ``path``.  Each has ``run_cell(run) -> dict`` (see ``run.py``)."""
