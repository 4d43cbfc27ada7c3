"""Command-line entry points (the port of ``pagraph_tpu/cli/``): ``train``,
``launch`` and ``scalebench`` over the shared flags of ``common``.  Run as
``python -m pagraph_tpu_torch.cli.<name>``; each runs on the card unless
``--cpu-devices N`` asks for the CPU."""
